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
14. ``multi_id_suggest``: ``tpe.suggest`` with 8 ids at the main path's
    history: one pair-score launch per unquantized family (2, not 16),
    the card's values against the CPU's from one set of uniform streams
    over 8 seeds (>= 80% equal to rtol 1e-5, every other value a near-tie
    under the CPU's own scorer), ms of the 8-id call against 8 single-id
    calls, in turns.
15. ``atpe_path``: serial ``fmin(algo=atpe.suggest)`` from the
    10,000-trial history, 8 suggests: per suggest the meta-parameters,
    locked labels, launches, ms and featurization ms; the meta-models
    loaded and the load warnings; then ``tpe.suggest`` with ATPE's locks
    and a result filter, card against CPU by the same rule.
16. ``anneal_mix``: ``anneal.suggest`` and ``mix.suggest`` over
    (0.5 tpe, 0.25 anneal, 0.25 rand), 16 evals each from a 1,000-trial
    history: values inside their supports, pair-score launches in a mix
    suggest exactly when it picked TPE.
17. ``parallel_backend``: ``TorchTrials(parallelism=8)``'s host plane at
    the main path's history (``tpe.suggest`` with 8192 candidates, the
    bench objective plus a 50 ms sleep, 32 evals): no error, 32 host
    trials, suggest calls with more than one id, 2 launches per call,
    wall ms per trial beside the serial loop's; then its device plane
    (``device_fn`` on the zoo's Branin, 64 evals): device batches only,
    each loss equal to the host objective to rel 1e-4.
18. ``file_trials``: ``FileTrials`` at the main path's history (a
    segment-log queue, one group commit) with 4 worker processes
    (``python -m hyperopt_tpu_torch.parallel.worker``): 32 trials of the
    bench objective plus a 50 ms sleep through fmin's asynchronous loop
    (``max_queue_len=4``; at the queue's 0.25 s poll, then at 0.02 s), 2
    pair-score launches per suggest call, owners
    from at least 2 processes, the fastqueue library loaded; wall ms per
    trial beside ``parallel_backend``'s and the serial loop's, ms of one
    ``refresh`` and one state count, the workers' start-up seconds.  Then
    a worker SIGKILLed while it holds a lease (2 s TTL): the reaper
    re-queues its trial and another worker finishes it at attempt 2.
    Then a fresh ``FileTrials`` reads the queue back and a second
    ``fmin`` continues it; the workers exit 0 on SIGTERM, none having
    initialised CUDA.
    Then ``fsck`` on that queue, after one more writer SIGKILLed inside
    a segment append: only rules a killed writer can leave, repaired,
    clean on a second pass, the same docs read back, the CLI exits 0.
19. ``space_lint``: ``fmin(validate_space=True)`` over bench.py's space
    from the 10,000-trial history, 4 trials on the serial loop (2
    pair-score launches each); a space with an SP error raises
    ``InvalidSpaceError`` before any launch; the lint's host ms.
20. ``device_recovery``: the pipelined fmin (k=1) at that history with
    the 50 ms objective, 8 trials: two device errors injected through the
    chaos harness's device site on consecutive dispatches (the trials
    equal a fault-free run's, 2 errors and 2 re-initializations, the
    history uploaded again, the kernel launched after the reset); one
    real ``torch.cuda.OutOfMemoryError`` (an allocation past the card's
    memory) on the first dispatch, recovered with the same trials;
    three consecutive injected errors raise, with no CPU fallback and
    every dispatch on the card.  Seconds per re-initialization.
21. ``profiler``: ``profiling.DeviceProfiler`` over 16 serial suggests at
    the main path's shape and one on the fused tier: per dispatch the
    CUDA-event device seconds beside the host-observed ones, modeled
    FLOPs and bytes, binding ceiling and share; the duty cycle; the
    Prometheus text parses; suggest p50 with and without the profiler,
    16 each in turns.
22. ``service``: the optimization service on the card, one replica
    (``OptimizationService(device="cuda")`` behind ``ServiceServer``).  4
    ``tpe`` studies over bench.py's space with 8192 candidates, each from
    a 10,000-trial history, served by 4 concurrent ``ServiceClient``
    threads for 8 suggest/report rounds each (the bench objective plus a
    50 ms sleep), then the same studies one client at a time: wall ms per
    trial, suggest p50/p99 (``ServiceStats``), dispatches, studies and
    pair-score launches per dispatch (2 per study), the launch counts set
    to 0 before each run and read after.  One batched dispatch of the 4
    studies, held until all are queued: each study's docs equal its
    unbatched suggest, 8 launches, the device's busy share of it
    (``torch.profiler``).  One study served serially from the 10,000-trial
    history gives serial ``fmin``'s trials.  Then ``python -m
    hyperopt_tpu_torch.service`` as its own process on a root holding a
    1,000-trial study: 6 trials, ``kill -9``, respawn on the same root and
    port, ``/readyz`` green (seconds), a suggest replayed by its
    idempotency key returns the same bytes, the study continues to an
    unkilled run's trials; the respawned server warmed every ledger key,
    served no cold suggest, exposes the service histograms and the
    profiler's rows on ``/metrics`` and breaches no SLO; SIGTERM exits 0
    and ``python -m hyperopt_tpu_torch.service fsck`` reports clean.
23. ``replica_failover``: two ``python -m hyperopt_tpu_torch.service
    --replica-id`` processes (``r1``, ``r2``, lease TTL 3 s) on one root
    and one card.  4 ``tpe`` studies created through a two-replica
    ``ServiceClient`` (names the ring splits 2 and 2), SIGTERM of both
    (every lease released, fence kept), each study's directory given the
    10,000-trial history, the leases handed back to their owners, both
    restarted; 4 concurrent rounds (the bench objective plus a 50 ms
    sleep), ``kill -9`` of ``r1``, then the first suggest of every study
    one at a time (the migrated ones first; the client rides through on
    ring failover and idempotent retries) and 3 concurrent rounds.  Checks:
    ``r2`` owns all 4; each takeover ok, fsck-clean, pre-warmed and under
    the 30 s MTTR bound; no first suggest after the kill is cold; ``r2``
    launched the pair-score kernel for them (its ``kernel_launches``);
    every study holds history + 8 trials, equal to a single-replica twin
    on the card; no lease renewal lost, no stale write dropped; SL608
    ``ok``; SIGTERM of ``r2`` exits 0 with every lease released and
    ``fsck`` of the root (FS409 included) exits 0.  Prints kill-to-expiry
    seconds, each takeover's split, the client-seen gap, wall ms per trial
    before and after the kill, ``r2``'s p50/p99 after it, and the
    phase's seconds.
24. ``mesh``: mesh execution on the one card.  The pair-score kernel's
    partials launch (one mesh shard's step) against its plain version at
    the main path's shape and a ragged one, its difference against the
    kernel's scores bit for bit, and the combine of sp = 1, 2, 4 shards
    against the unsharded kernel, within TOLERANCE; ``DeviceMesh.auto()``
    on one card is degenerate and ``tpe.suggest(mesh="auto")`` gives
    ``mesh=None``'s docs and launches; virtual 1x2, 2x1 and 2x2 meshes
    (slots on cuda:0, each its own stream): 8 seeds at the 10,000-trial
    history against the unsharded kernel path (every mismatch printed, and
    a near-tie within twice TOLERANCE), a 16-trial fmin on
    ``tests/test_mesh.py``'s space trial for trial equal to ``mesh=None``,
    dp*sp launches per scorer call, the sharded scorer's event ms (also
    with the garbage collector off) beside the unsharded kernel's; the
    2x2 mesh's main path (fmin at the 10,000-trial history, 8 launches
    per suggest, the counts set to 0 before and read after) beside the
    same fmin without a mesh in the same process state, each suggest's
    host ms split by stage, and one steady suggest each way under
    ``torch.profiler`` (host ms per stage, CUDA runtime calls, the card's
    busy ms); a one-rank NCCL group (all-reduce MAX and SUM
    of a CUDA tensor, ``global_mesh``); ``TorchTrials(device_fn=...)`` on
    a virtual 2x1 mesh against the unsharded device plane.
25. ``self_lint``: the port's ``run_self_lint()`` on this machine (no
    JAX): race, durability, static program and protocol passes and the
    small-scope model check; no error finding; each section's findings
    and seconds.
26. ``recompile_audit``: ``audit_tpe_run`` on the card for 200 trials: no
    PL205 (one compile event per trial-count bucket and family), the
    events per bucket, one pair-score launch per TPE suggest.
27. ``checkpoint``: ``fmin(trials_save_file=<dir>/run.orbax)`` from the
    10,000-trial history for 8 trials, resumed in a fresh ``Trials`` to 16
    with the same ``rstate`` stream: trial for trial an uninterrupted
    16-trial run; the newest step's payload truncated, restore falls back
    to the step before; save ms per step, and at 10,000 trials one step's
    bytes and save ms beside the pickle path's.
28. ``device_sample_batch``: bench.py's space drawn at n = 65,536 on the
    card under ``torch.cuda.set_sync_debug_mode("error")`` (no readback):
    the tensors' device, a KS test per label against ``sample_batch``'s
    draw at another seed, ms per draw beside ``sample_batch``'s.
29. ``quality``: ``scripts/quality_study_torch.py`` at c = 65,536 on the
    card (four domains, seeds 0-3, 60 trials): each mean regret beside
    the reference's per-seed range in ``QUALITY.json``, its verdict and
    the wall seconds; then ``quality_summary``.
30. ``train_atpe``: ``python -m hyperopt_tpu_torch.models.train_atpe
    --rows-out`` (its ``main``) for one shard of the corpus sweep on the
    card: ``many_dists`` with 20 configs, 8 continuation evals and
    checkpoints 20 28 36 45, seeds 0-1 (the sweep's 13 cut to 2): 8 rows,
    every feature finite, every label inside the grid, no tensor in a
    row, the shard read back equal, the pair-score kernel launched, the
    shipped artifacts' digests unchanged; the kernel against its plain
    version on the first and last inputs of each shape the build gave it
    (``train_atpe_kernel_vs_plain`` lines); then seed 0 alone with
    ``--device cpu`` on the same machine; states, trials, suggests,
    seconds per state, wall ms per TPE trial and the median host ms of
    one suggest each way; whether sklearn
    imports (where it does not, a fitting run fails naming it before any
    row is built).
31. ``timing``: each kernel, its plain version and one PyTorch library call
    computing the same function, by CUDA events at the main-path shape;
    the kernel's device ms per launch (``torch.profiler``); its bound, the
    larger of the f32 operations at the f32 peak, the issue slots and SFU
    time with the exps split at best between the SFU and the FMA pipe, and
    the bytes at the memory rate, and its share of that bound; beside it
    the SFU-only time and its share.

A ``process_state`` line after ``main_path``, at the start of ``mesh``
and before its main path lists what else runs (threads, other processes,
observers, a profiler), the heap's and the allocator's counters, the
card's clocks and use, the host µs of one small CUDA op and the event ms
of the pair-score kernel.

Then the ``kernels`` line (``pair_lse_partials``' launches are the mesh phase's
main path's; with ``launches_service``, each kernel's launches in
the service phase's concurrent run, and ``launches_replica_failover``,
the surviving replica's launches after the kill; ``launches_recompile_audit``,
``launches_checkpoint``, ``launches_quality`` and ``launches_train_atpe``,
those of this order's phases 26, 27, 29 and 30), a ``total`` line with the
script's seconds, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of
``hyperopt_tpu``; needs one card.
"""

import contextlib
import copy
import datetime
import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import threading
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


def card_agrees_with_cpu(T, domain, trials, ids, seeds, cards=None, **kw):
    """``tpe.suggest`` on the card and on the CPU from the same streams:
    (pairs, pairs equal to rtol 1e-5, mismatches) over every (id, label)
    value; a mismatch is ``(seed, id index, label, card value, CPU
    value)``.  ``cards``, a list, receives the card's docs of each seed."""
    pairs, close, mismatches = 0, 0, []
    with cpu_drawn_streams():
        for seed in seeds:
            card = T.tpe.suggest(ids, domain, trials, seed, **kw)
            if cards is not None:
                cards.append(card)
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
    """Each mismatch's gap under the CPU suggest's own scores: how much
    higher the CPU's winner scores than the card's.  Both winners are
    looked up among the CPU suggest's candidates for that id
    (``tpe.plain_label_scores``: its candidates, and its scores from the
    same plain products it made; the card's winner is the CPU candidate
    nearest its value, since the card's draw may differ from the CPU's by
    an ulp), so the CPU's winner scores at least as high and the gap is
    never negative.  The card's argmax can differ from the CPU's only
    where that gap is at most twice the per-score TOLERANCE between the
    kernel and the plain version (each of the two scores may be off by one
    TOLERANCE), so a larger gap fails.  Only the chunks holding the two
    winners are scored, in f32 and f64, once per (seed, label)."""
    groups = {}
    for m in mismatches:
        groups.setdefault((m[0], m[2]), []).append(m)
    rows = []
    for (seed, lb), group in groups.items():
        cands, _ = T.tpe.plain_label_scores(ids, domain, trials, seed, lb, at=[], **kw)
        picks = []
        for _, j, _, card_v, cpu_v in group:
            row = cands[j]
            picks.append((j, int(np.argmin(np.abs(row - card_v))),
                          int(np.argmin(np.abs(row - cpu_v)))))
        at = [j * cands.shape[1] + i for j, a, b in picks for i in (a, b)]
        _, s = T.tpe.plain_label_scores(ids, domain, trials, seed, lb, at=at, **kw)
        _, s64 = T.tpe.plain_label_scores(ids, domain, trials, seed, lb,
                                          dtype=torch.float64, at=at, **kw)
        for (_, _, _, card_v, cpu_v), (j, i_card, i_cpu) in zip(group, picks):
            assert np.isclose(cands[j, i_cpu], cpu_v, rtol=1e-6), (lb, cands[j, i_cpu], cpu_v)
            pick = [i_card, i_cpu]
            allow, _ = allowance(torch.from_numpy(s[j, pick]), torch.from_numpy(s64[j, pick]))
            rows.append({"seed": seed, "id": j, "label": lb, "card": card_v, "cpu": cpu_v,
                         "card_candidate": float(cands[j, i_card]),
                         "gap": float(s[j, i_cpu] - s[j, i_card]),
                         "allow": 2 * float(allow.min())})
    return rows


def split_mismatches(T, domain, trials, ids, mismatches, card="cuda", **kw):
    """Each card-vs-CPU mismatch's cause, read from both suggests' own
    candidates (``tpe.plain_label_scores`` on the card and on the CPU, from
    the same streams), with the card's winner looked up among the card's
    candidates and the CPU's among the CPU's:

    - ``draw``: both winners sit at one candidate index, so the argmaxes
      agree and the card drew that candidate otherwise than the CPU;
    - ``order_kernel``: the plain scorer on the card, over the card's own
      candidates, picks the CPU's index (the kernel orders a near-tie
      otherwise than its plain version);
    - ``order_plain``: it picks the card's index and both candidates are
      drawn alike on both sides (the card's plain products order the tie
      otherwise than the CPU's); ``order_draw`` when they are not alike.

    One row per mismatch; the card's plain scores are read once per
    (seed, label).  ``card`` is the device the mismatching suggest ran on."""
    groups = {}
    for m in mismatches:
        groups.setdefault((m[0], m[2]), []).append(m)
    rows = []
    with cpu_drawn_streams():
        for (seed, lb), group in groups.items():
            cc, sc = T.tpe.plain_label_scores(ids, domain, trials, seed, lb,
                                              device=card, **kw)
            cp, _ = T.tpe.plain_label_scores(ids, domain, trials, seed, lb,
                                             device="cpu", **kw)
            for _, j, _, card_v, cpu_v in group:
                i_card = int(np.argmin(np.abs(cc[j] - card_v)))
                i_cpu = int(np.argmin(np.abs(cp[j] - cpu_v)))
                plain_card = int(np.argmax(sc[j]))
                if i_card == i_cpu:
                    cause = "draw"
                elif plain_card == i_cpu:
                    cause = "order_kernel"
                elif cc[j, i_card] == cp[j, i_card] and cc[j, i_cpu] == cp[j, i_cpu]:
                    cause = "order_plain"
                else:
                    cause = "order_draw"
                rows.append({"seed": seed, "id": j, "label": lb, "cause": cause,
                             "card_exact": bool(cc[j, i_card] == card_v),
                             "plain_gap_on_card": float(sc[j, i_cpu] - sc[j, i_card])})
    return rows


def split_tables(rows):
    """The causes of :func:`split_mismatches`, counted, and by label."""
    causes, by_label = {}, {}
    for r in rows:
        causes[r["cause"]] = causes.get(r["cause"], 0) + 1
        slot = by_label.setdefault(r["label"], {})
        slot[r["cause"]] = slot.get(r["cause"], 0) + 1
    return {"causes": causes, "causes_by_label": by_label,
            "card_winner_not_a_card_candidate": sum(not r["card_exact"] for r in rows)}


MULTI_IDS = 8
# The 8-id suggest's card-vs-CPU rule.  At 8 x 8192 candidates per label
# the log-scale `lr` winners sit among near-ties that two f32 scorers
# order differently: over these seeds an H100 agreed on 277 of 320 (id,
# label) values, 33-36 of 40 per seed (PERF.md §6), hence the share floor
# of 0.8; every other value must be a near-tie (``near_ties``).
AGREEMENT_SEEDS = range(8)
AGREEMENT_SHARE = 0.8


def assert_agreement(pairs, close, ties, split=None):
    """At least AGREEMENT_SHARE of the values equal to rtol 1e-5, and each
    mismatch a near-tie within the allowance TOLERANCE implies; on failure
    the message carries the share, the mismatches by label, the ones
    outside the allowance and, given the rows of :func:`split_mismatches`,
    their causes."""
    outside = [t for t in ties if not 0.0 <= t["gap"] <= t["allow"]]
    assert close >= AGREEMENT_SHARE * pairs and not outside, dict(
        close=close, pairs=pairs, share=close / pairs, **mismatch_tables(ties),
        **(split_tables(split) if split is not None else {}),
        worst_gap_over_allowance=max((t["gap"] / t["allow"] for t in ties), default=0.0),
        outside_allowance=outside)


def mismatch_tables(ties):
    """The mismatches counted by label, and by label and seed."""
    by_label, by_label_seed = {}, {}
    for t in ties:
        by_label[t["label"]] = by_label.get(t["label"], 0) + 1
        key = f'{t["label"]}/{t["seed"]}'
        by_label_seed[key] = by_label_seed.get(key, 0) + 1
    return {"mismatches_by_label": by_label, "mismatches_by_label_seed": by_label_seed}


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
           "per_seed": per_seed, "near_ties": ties, **mismatch_tables(ties),
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
    return wall_ms / n_evals


LEASE_OBJECTIVE_S = 1.0  # long enough that a kill lands while a lease is held


def lease_objective(c):
    time.sleep(LEASE_OBJECTIVE_S)
    return bench_objective(c)


class QueueWorkers:
    """``n`` processes of ``python -m hyperopt_tpu_torch.parallel.worker``
    on one queue, each logging to its own file.  The objective's module
    (``chip_smoke``) is found through an absolute ``PYTHONPATH``: each
    trial runs inside the worker's workdir."""

    def __init__(self, qdir, n):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.logs = [os.path.join(qdir, f"worker{i}.log") for i in range(n)]
        self.t0 = time.perf_counter()
        self.procs = []
        for log in self.logs:
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "hyperopt_tpu_torch.parallel.worker",
                     "--queue", qdir, "--poll-interval", "0.02", "--reserve-timeout", "60"],
                    env=env, cwd=root, stdout=f, stderr=subprocess.STDOUT))
        self.killed = set()

    def text(self, i):
        with open(self.logs[i]) as f:
            return f.read()

    def wait_ready(self, timeout=120):
        """Seconds from the start to each worker's readiness line (its
        signal handlers installed, its queue handle open)."""
        ready = {}
        deadline = time.monotonic() + timeout
        while len(ready) < len(self.procs):
            for i, proc in enumerate(self.procs):
                if i not in ready and "ready on" in self.text(i):
                    ready[i] = time.perf_counter() - self.t0
                assert proc.poll() is None, (i, self.text(i))
            assert time.monotonic() < deadline, [self.text(i) for i in range(len(self.procs))]
            time.sleep(0.02)
        return [ready[i] for i in range(len(self.procs))]

    def pid_of(self, owner):
        return int(str(owner).rsplit(":", 1)[1])

    def kill_lease_holder(self, jobs, lease_ttl, max_age_s=0.3, timeout=60):
        """SIGKILL a worker mid-objective: one holding a lease granted in
        the last ``max_age_s`` and renewed under ``lease_ttl`` (a worker
        grants its first lease after a policy change with the TTL it had,
        and adopts the policy's at its first heartbeat); returns (tid,
        owner)."""
        live = {p.pid: p for p in self.procs if p.poll() is None}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for name in sorted(os.listdir(os.path.join(jobs.root, "leases"))):
                if not name.endswith(".lease"):
                    continue
                tid = int(name.split(".")[0])
                lease = jobs.read_lease(tid)  # None: released or torn meanwhile
                if lease is None:
                    continue
                pid = self.pid_of(lease["owner"])
                now = time.time()
                if (pid in live and now - lease["granted_at"] < max_age_s
                        and lease["expires_at"] - now <= lease_ttl):
                    os.kill(pid, 9)
                    live[pid].wait(timeout=30)
                    self.killed.add(pid)
                    return tid, lease["owner"]
            time.sleep(0.01)
        raise AssertionError("no worker took a lease to kill")

    def stop(self):
        """SIGTERM every live worker; each finishes its trial and exits 0.
        Returns {pid: (exit code, cuda initialized)}."""
        out = {}
        for i, proc in enumerate(self.procs):
            if proc.pid in self.killed:
                continue
            proc.terminate()
            rc = proc.wait(timeout=60)
            m = re.search(r"cuda initialized: (\w+)", self.text(i))
            out[proc.pid] = (rc, m.group(1) if m else None)
        return out

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def phase_file_trials(T, counters, serial_rows, parallel_ms_per_trial, n_evals=32,
                      n_workers=4, n_lease=6, n_resume=4):
    """``FileTrials`` with 4 out-of-process workers at the main path's
    history: (a) 32 trials through fmin's asynchronous loop with the
    speculative engine, at the queue's poll interval and at 0.02 s; (b) one worker SIGKILLed while it holds a lease
    under a 2 s lease TTL, the lease reaper re-queues its trial and
    another worker finishes it; (c) a fresh ``FileTrials`` reads the
    queue back and a second ``fmin`` continues it."""
    import shutil
    import tempfile

    import chip_smoke as cs  # the objectives pickle as chip_smoke.<name>
    from hyperopt_tpu_torch import native
    from hyperopt_tpu_torch.parallel.file_trials import FileJobs
    from hyperopt_tpu_torch.resilience import RetryPolicy

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    qdir = tempfile.mkdtemp(prefix="file_trials_", dir=os.path.join(root, "build"))
    workers = None
    try:
        # the native scan of the legacy layout, built on this machine
        assert native.load_fastqueue() is not None, "fastqueue did not build or load"
        doc_q = FileJobs(os.path.join(qdir, "doc_layout"), backend="doc")
        for tid in range(64):
            doc_q.insert({"tid": tid, "state": tid % 3, "misc": {"tid": tid}})
        scan = native.count_states(os.path.join(doc_q.root, "trials"))
        assert scan is not None and scan[0][:3] == [22, 21, 21], scan

        # (a) the main path on FileTrials
        q = os.path.join(qdir, "q")
        t0 = time.perf_counter()
        filled = T.FileTrials(q)
        # the history's ids come from the queue's counter, as a driver's do
        assert filled.new_trial_ids(N_HISTORY) == list(range(N_HISTORY))
        prefilled_trials(T, N_HISTORY, trials=filled)
        prefill_s = time.perf_counter() - t0
        assert T.FileTrials(q).jobs.backend == "segment"
        workers = QueueWorkers(q, n_workers)
        startup_s = workers.wait_ready()
        # at FileTrials' own poll interval (0.25 s), then at TorchTrials'
        # (0.02 s): the driver's sleep between rounds against the rest
        for poll in (None, 0.02):
            trials = T.FileTrials(q)
            n0 = len(trials)
            calls = []
            it = T.FMinIter(counted_tpe(T, calls, n_EI_candidates=N_CAND),
                            T.Domain(cs.training_objective, bench_space(T.hp)), trials,
                            rstate=np.random.default_rng(0), max_evals=n0 + n_evals,
                            max_queue_len=4, show_progressbar=False, poll_interval_secs=poll)
            for c in counters:
                c.launches = 0
            with failure_log() as failed:
                t0 = time.perf_counter()
                it.exhaust()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {c.__name__: c.launches for c in counters}
            new = [d for d in trials._dynamic_trials if d["tid"] >= n0]
            owners = {d["owner"] for d in new}
            t0 = time.perf_counter()
            trials.refresh()
            refresh_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            n_unfinished = trials.count_by_state_unsynced(
                [T.JOB_STATE_NEW, T.JOB_STATE_RUNNING])
            count_ms = (time.perf_counter() - t0) * 1e3
            emit("file_trials", part="main_path", backend=trials.jobs.backend,
                 n_history=n0, n_evals=n_evals, n_EI_candidates=N_CAND,
                 n_workers=n_workers, max_queue_len=4, objective_ms=OBJECTIVE_SLEEP_S * 1e3,
                 poll_interval_s=it.poll_interval_secs, prefill_s=prefill_s,
                 worker_startup_s=startup_s, wall_ms=wall_ms,
                 wall_ms_per_trial=wall_ms / n_evals,
                 parallel_backend_wall_ms_per_trial=parallel_ms_per_trial,
                 serial_wall_ms_per_trial={k: r["wall_ms_per_trial"]
                                           for k, r in serial_rows.items()},
                 suggest_calls=len(calls), ids_per_call=calls, launches=launches,
                 launches_per_suggest_call=launches["pair_score_batched"] / len(calls),
                 n_trials=len(trials._dynamic_trials), refresh_ms=refresh_ms,
                 count_by_state_unsynced_ms=count_ms, worker_processes=len(owners),
                 speculation=it.speculation_stats.summary(),
                 faults=it.fault_stats.summary(), fastqueue_loaded=True,
                 failed_log_lines=failed.lines)
            assert len(new) == n_evals, len(new)
            assert [d["state"] for d in new] == [T.JOB_STATE_DONE] * n_evals
            for doc in new:
                check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
                assert math.isfinite(doc["result"]["loss"])
            assert len(owners) >= 2, owners
            assert launches["pair_score_batched"] == 2 * len(calls), (calls, launches)
            assert launches["fused_suggest"] == 0, launches
            assert n_unfinished == 0
            assert not failed.lines, failed.lines

        # (b) kill a lease holder; the reaper re-queues, another worker finishes
        del trials.attachments["FMinIter_Domain"]  # this part's objective
        n_before = len(trials._dynamic_trials)
        stats = T.observability.FaultStats()
        policy = RetryPolicy(max_attempts=3, backoff_base=0.1, lease_ttl=2.0)
        it = T.FMinIter(partial(T.tpe.suggest, n_EI_candidates=N_CAND),
                        T.Domain(cs.lease_objective, bench_space(T.hp)), trials,
                        rstate=np.random.default_rng(1), max_evals=n_before + n_lease,
                        max_queue_len=3, show_progressbar=False, retry_policy=policy,
                        fault_stats=stats)
        box = {}

        def kill():
            try:
                box["killed"] = workers.kill_lease_holder(trials.jobs, policy.lease_ttl)
            except BaseException as e:  # read below
                box["error"] = e

        killer = threading.Thread(target=kill, daemon=True)
        with failure_log() as failed:
            t0 = time.perf_counter()
            killer.start()
            it.exhaust()
            killer.join(timeout=60)
            lease_wall_s = time.perf_counter() - t0
        assert "error" not in box, box.get("error")
        tid, owner = box["killed"]
        trials.refresh()
        doc = trials.jobs.read_doc(tid)
        new = [d for d in trials._dynamic_trials if d["tid"] >= n_before]
        emit("file_trials", part="kill_and_recover", lease_ttl_s=policy.lease_ttl,
             objective_s=LEASE_OBJECTIVE_S, n_evals=n_lease, killed_tid=tid,
             killed_owner=owner, finished_by=doc["owner"], attempts=doc["misc"]["attempts"],
             faults=stats.summary(), wall_s=lease_wall_s, failed_log_lines=failed.lines)
        assert doc["state"] == T.JOB_STATE_DONE and doc["misc"]["attempts"] == 2, doc
        assert doc["owner"] != owner, (doc["owner"], owner)
        assert stats.get("lease_expired") >= 1 and stats.get("lease_reclaimed") >= 1
        assert stats.get("lease_quarantined") == 0, stats.summary()
        assert len(new) == n_lease and all(d["state"] == T.JOB_STATE_DONE for d in new)
        assert not failed.lines, failed.lines

        # (c) resume: a fresh handle reads everything; a second fmin continues
        reopened = T.FileTrials(q)
        assert ({d["tid"]: d for d in reopened._dynamic_trials}
                == {d["tid"]: d for d in trials._dynamic_trials})
        n_left = len(reopened)
        del reopened.attachments["FMinIter_Domain"]
        t0 = time.perf_counter()
        T.fmin(cs.training_objective, bench_space(T.hp),
               algo=partial(T.tpe.suggest, n_EI_candidates=N_CAND),
               max_evals=n_left + n_resume, trials=reopened, max_queue_len=4,
               rstate=np.random.default_rng(2), show_progressbar=False)
        resume_wall_s = time.perf_counter() - t0
        reopened.refresh()
        tids = sorted(d["tid"] for d in reopened._dynamic_trials)
        exits = workers.stop()
        logs = [workers.text(i) for i in range(n_workers)]
        bad_lines = [ln for text in logs for ln in text.splitlines()
                     if "Traceback" in ln or " failed: " in ln]
        emit("file_trials", part="resume", n_before=n_left, n_after=len(reopened),
             first_new_tid=tids[n_left], wall_s=resume_wall_s,
             worker_exits={str(k): v for k, v in exits.items()},
             worker_error_lines=bad_lines, phase_s=time.perf_counter() - t_phase)
        assert len(reopened) == n_left + n_resume
        assert all(d["state"] == T.JOB_STATE_DONE for d in reopened._dynamic_trials)
        assert tids[n_left] > max(tids[:n_left]) and len(set(tids)) == len(tids)
        assert len(exits) == n_workers - 1
        assert all(v == (0, "False") for v in exits.values()), exits
        assert not bad_lines, bad_lines
        # (d) fsck on this queue, every writer stopped
        phase_fsck(T, q)
    finally:
        if workers is not None:
            workers.close()
        shutil.rmtree(qdir, ignore_errors=True)


# rules a writer killed mid-operation can leave in a queue (a torn doc or
# segment tail, its lease or lock, a tmp dropping, the id allocator's lock,
# a compactor's orphan); the others mean a fault of the store itself
KILLED_WRITER_RULES = {"FS401", "FS402", "FS403", "FS406", "FS408", "FS410", "FS412"}

_TORN_APPEND = """
import sys
sys.path.insert(0, {root!r})
from hyperopt_tpu_torch.resilience import chaos
from hyperopt_tpu_torch.parallel.file_trials import FileJobs
with chaos.active(chaos.ChaosMonkey(chaos.ChaosConfig(seed=5, p_torn_segment=1.0))):
    FileJobs({q!r}).insert({{"tid": {tid}, "state": 0, "misc": {{"tid": {tid}}}}})
raise SystemExit("the chaos site never fired")
"""


def phase_fsck(T, q):
    """``fsck`` on ``file_trials``' queue after its SIGKILL and resume, and
    after one more writer SIGKILLed inside a segment append (the chaos
    harness's torn-segment site, a real process): the dry run lists only
    rules a killed writer can leave, the repair reads clean on a second
    pass, a fresh ``FileTrials`` reads the same docs as before the repair,
    and the CLI exits 0 on the clean queue."""
    from hyperopt_tpu_torch.resilience import fsck

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    first = fsck.fsck_queue(q)
    first_s = time.perf_counter() - t0
    tid = max(d["tid"] for d in T.FileTrials(q)._dynamic_trials) + 100
    kill = subprocess.run([sys.executable, "-c", _TORN_APPEND.format(root=root, q=q, tid=tid)],
                          capture_output=True, text=True, timeout=300)
    before = sorted((d["tid"], d["state"]) for d in T.FileTrials(q)._dynamic_trials)
    t0 = time.perf_counter()
    dry = fsck.fsck_queue(q)
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    repaired = fsck.fsck_queue(q, repair=True)
    repair_s = time.perf_counter() - t0
    second = fsck.fsck_queue(q)
    after = sorted((d["tid"], d["state"]) for d in T.FileTrials(q)._dynamic_trials)
    cli = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.resilience.fsck", q],
                         capture_output=True, text=True, timeout=300, cwd=root)
    emit("fsck", n_docs=dry.n_docs, after_file_trials=first.by_rule(), after_file_trials_s=first_s,
         writer_exit=kill.returncode, dry_run=dry.by_rule(), dry_run_s=dry_s,
         repaired=repaired.by_rule(), repair_s=repair_s,
         repair_actions=[f.action for f in repaired.findings],
         second_pass_clean=second.clean, docs_equal_before_and_after=before == after,
         cli_exit=cli.returncode, cli_last_line=cli.stdout.strip().splitlines()[-1:])
    assert kill.returncode == -9, (kill.returncode, kill.stderr)
    assert set(first.by_rule()) <= KILLED_WRITER_RULES, first.format()
    assert set(dry.by_rule()) <= KILLED_WRITER_RULES and "FS410" in dry.by_rule(), dry.format()
    assert repaired.clean and second.clean and not second.findings, second.format()
    assert before == after and tid not in {t for t, _ in after}
    assert cli.returncode == 0 and cli.stdout.strip().endswith("clean"), cli.stdout + cli.stderr


def phase_space_lint(T, counters, n_trials=4, reps=20):
    """``fmin(validate_space=True)`` over bench.py's space from the
    10,000-trial history: 4 trials on the card (the serial loop), the
    pair-score kernel launched twice per suggest; a space with an SP error
    raises ``InvalidSpaceError`` before any launch; the lint's host ms."""
    from hyperopt_tpu_torch.analysis import lint_space
    from hyperopt_tpu_torch.pyll.base import scope

    space = bench_space(T.hp)
    lint_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        diags = lint_space(space)
        lint_ms.append((time.perf_counter() - t0) * 1e3)
    assert diags == [], diags
    trials = prefilled_trials(T, N_HISTORY)
    for c in counters:
        c.launches = 0
    T.fmin(bench_objective, space, algo=partial(T.tpe.suggest, n_EI_candidates=N_CAND),
           max_evals=N_HISTORY + n_trials, trials=trials, rstate=np.random.default_rng(0),
           show_progressbar=False, max_speculation=0, validate_space=True)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    assert len(trials.trials) == N_HISTORY + n_trials
    for doc in trials.trials[N_HISTORY:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
    bad = dict(space, x=scope.float(scope.hyperopt_param("x", scope.loguniform(0.0, 100.0))))
    for c in counters:
        c.launches = 0
    try:
        T.fmin(bench_objective, bad, algo=partial(T.tpe.suggest, n_EI_candidates=N_CAND),
               max_evals=N_HISTORY + n_trials + 1, trials=trials,
               rstate=np.random.default_rng(1), show_progressbar=False, validate_space=True)
        raised = None
    except T.InvalidSpaceError as e:
        raised = sorted(d.rule for d in e.diagnostics)
    bad_launches = {c.__name__: c.launches for c in counters}
    emit("space_lint", n_history=N_HISTORY, n_trials=n_trials, n_EI_candidates=N_CAND,
         launches=launches, lint_ms_median=float(np.median(lint_ms)), lint_ms_all=lint_ms,
         bad_space_rules=raised, bad_space_launches=bad_launches)
    assert launches["pair_score_batched"] == 2 * n_trials, launches
    assert launches["fused_suggest"] == 0, launches
    assert raised == ["SP105"], raised
    assert not any(bad_launches.values()), bad_launches
    assert len(trials.trials) == N_HISTORY + n_trials
    return launches


class DispatchLog:
    """A suggest observer that runs ``fault(i)`` on dispatch ``i`` (before
    its launches), and records each dispatch's device and the pair-score
    launch count at that moment; ``histories`` holds every
    ``DeviceHistory`` a suggest used."""

    def __init__(self, T, fault=None):
        from hyperopt_tpu_torch.algos import tpe_device
        from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

        self.td, self.counter, self.fault = tpe_device, pair_score_batched, fault
        self.devices, self.launches_at, self.histories, self.failed = [], [], [], []
        self._real = tpe_device.device_history_for

    def __call__(self, requests):
        i = len(self.devices)
        self.devices.append(str(requests[0][1][1].device))
        self.launches_at.append(self.counter.launches)
        if self.fault is not None:
            try:
                self.fault(i)
            except BaseException:
                self.failed.append(i)
                raise

    def history_for(self, *args, **kwargs):
        dh = self._real(*args, **kwargs)
        if all(dh is not h for h in self.histories):
            self.histories.append(dh)
        return dh

    def __enter__(self):
        self.td._suggest_observers.append(self)
        self.td.device_history_for = self.history_for
        return self

    def __exit__(self, *exc):
        self.td._suggest_observers.remove(self)
        self.td.device_history_for = self._real
        return False


def recovery_run(T, counters, fault=None):
    """The pipelined fmin (k=1) at the main path's history with the 50 ms
    objective, 8 trials, under a DispatchLog with ``fault``; returns
    (FMinIter or the exception, suggested values, the log, launches)."""
    trials = prefilled_trials(T, N_HISTORY)
    it = T.FMinIter(partial(T.tpe.suggest, n_EI_candidates=N_CAND),
                    T.Domain(training_objective, bench_space(T.hp)), trials,
                    rstate=np.random.default_rng(0), max_evals=N_HISTORY + N_SUGGESTS,
                    show_progressbar=False, max_speculation=1)
    for c in counters:
        c.launches = 0
    with DispatchLog(T, fault) as log:
        try:
            it.exhaust()
            out = it
        except Exception as e:  # read by the caller
            out = e
        torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    return out, suggested(trials), log, launches


def phase_device_recovery(T, counters):
    """``DeviceRecovery`` on the pipelined fmin at the main path's size:
    (i) two device errors injected through the chaos harness's device site
    on consecutive dispatches, within ``max_reinits=2``: the trials equal a
    fault-free run's, ``FaultStats`` reads 2 errors and 2
    re-initializations, the history was uploaded again and the pair-score
    kernel launched after the reset; (ii) one real CUDA error, an
    allocation larger than the card's memory on the first dispatch:
    the run recovers with the same trials; (iii) three consecutive
    injected errors: the run raises, ``cpu_fallback`` stays 0 and every
    dispatch's tensors lay on the card."""
    from hyperopt_tpu_torch.resilience.chaos import ChaosConfig, ChaosMonkey

    clean, ref, clean_log, clean_launches = recovery_run(T, counters)
    assert isinstance(clean, T.FMinIter), clean
    rows = {"fault_free": {"launches": clean_launches,
                           "full_rebuilds": sum(h.full_rebuilds for h in clean_log.histories)}}

    def injected(at):
        monkey = ChaosMonkey(ChaosConfig(seed=0, p_device_error=1.0))

        def fault(i):
            if i in at:
                monkey.maybe_device_error()  # raises SyntheticDeviceError
        return fault

    oom = {}

    def real_oom(i):
        if i == 0:
            # past the card's whole memory: no cached block a retry frees
            # can make room for it
            _, total = torch.cuda.mem_get_info()
            oom["requested_bytes"] = total + (1 << 30)
            torch.empty(oom["requested_bytes"], dtype=torch.uint8, device=DEV)

    for name, fault in (("two_injected", injected({2, 3})), ("real_oom", real_oom),
                        ("three_injected", injected({2, 3, 4}))):
        out, vals, log, launches = recovery_run(T, counters, fault)
        recovered = isinstance(out, T.FMinIter)
        rec = (out.device_recovery if recovered else None)
        row = {"recovered": recovered, "error": None if recovered else type(out).__name__,
               "launches": launches, "dispatch_devices": sorted(set(log.devices)),
               "n_dispatches": len(log.devices),
               "full_rebuilds": sum(h.full_rebuilds for h in log.histories),
               "trials_equal_to_fault_free": sum(a == b for a, b in zip(vals, ref))}
        if recovered:
            # the pair-score launches from the first dispatch after the
            # last failed one (after the last reset) to the end
            row.update(faults=out.fault_stats.counts(), reinit_s=list(rec.reinit_seconds),
                       failed_dispatches=log.failed,
                       launches_after_last_reset=launches["pair_score_batched"]
                       - log.launches_at[log.failed[-1] + 1])
        if name == "real_oom":
            row["requested_bytes"] = oom.get("requested_bytes")
        rows[name] = row
        emit("device_recovery", case=name, n_history=N_HISTORY, n_trials=N_SUGGESTS,
             max_speculation=1, **row)
        assert all(d.startswith("cuda") for d in log.devices), log.devices
        if name == "three_injected":
            assert not recovered and row["error"] == "SyntheticDeviceError", out
            continue
        assert recovered, out
        faults = out.fault_stats
        assert vals == ref, (vals, ref)
        assert faults.get("cpu_fallback") == 0 and not rec.cpu_fallback_active
        if name == "two_injected":
            assert (faults.get("device_error"), faults.get("device_reinit")) == (2, 2), \
                faults.counts()
        else:
            assert (faults.get("device_error"), faults.get("device_reinit")) == (1, 1), \
                faults.counts()
        assert row["full_rebuilds"] > rows["fault_free"]["full_rebuilds"], row
        assert row["launches_after_last_reset"] > 0, row
    # (iii) the run raised: the budget's end, not a move to the CPU
    return rows


SAMPLE_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? \S+$')


def phase_profiler(T, counters, trials, n=16, rounds=16):
    """The roofline profiler over 16 serial suggests at the main path's
    shape on the default tier and one dispatch on the fused tier: per
    dispatch the CUDA-event device seconds beside the host-observed ones,
    the modeled FLOPs and bytes, the binding ceiling and the share of it;
    DeviceStats' duty cycle; the Prometheus text (every sample line
    parses); then the installed overhead: steady suggest p50 with and
    without the profiler, in turns."""
    from hyperopt_tpu_torch import profiling
    from hyperopt_tpu_torch.algos import tpe_device
    from hyperopt_tpu_torch.observability import DeviceStats, build_info, render_prometheus

    domain = T.Domain(bench_objective, bench_space(T.hp))
    base = len(trials.trials)
    counter = iter(range(10 ** 6))

    def suggest():
        i = next(counter)
        t0 = time.perf_counter()
        T.tpe.suggest([base + i], domain, trials, 5000 + i, n_EI_candidates=N_CAND)
        return (time.perf_counter() - t0) * 1e3

    suggest()  # this domain's history upload
    stats = DeviceStats()
    events = []
    records = []
    for c in counters:
        c.launches = 0
    with profiling.DeviceProfiler(stats=stats) as prof:
        def also_event(requests):
            return events.append
        tpe_device._suggest_observers.append(also_event)
        try:
            for _ in range(n):
                suggest()
                records.append(profiling.last_dispatch_record())
            with scorer_env(HYPEROPT_TPU_SCORER="fused"):
                suggest()
                records.append(profiling.last_dispatch_record())
        finally:
            tpe_device._suggest_observers.remove(also_event)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    assert tpe_device._suggest_observers == []
    rows = []
    for rec, ev in zip(records, events):
        host_s = ev["launch_s"] + ev["wait_s"] + ev["readback_s"]
        rows.append({"sig": rec["sig"][-60:], "device_s": rec["device_s"],
                     "host_observed_s": host_s, "flops": rec["flops"],
                     "hbm_bytes": rec["hbm_bytes"], "binding_ceiling": rec["binding_ceiling"],
                     "roofline_pct": rec["roofline_pct"], "compiled": rec["compiled"]})
    text = render_prometheus(device=stats, build=build_info())
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    bad = [ln for ln in samples if not SAMPLE_LINE.match(ln)]
    summ = stats.summary()
    # installed overhead: steady p50 with and without, in turns
    times = {"with": [], "without": []}
    installed = profiling.DeviceProfiler(stats=DeviceStats())
    for r in range(2 * rounds):
        name = ("with", "without")[(r + r // 2) % 2]  # ABBA turns
        if name == "with":
            with installed:
                times[name].append(suggest())
        else:
            times[name].append(suggest())
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    emit("profiler", n_suggests=n, fused_dispatches=1, launches=launches,
         dispatches=rows, duty_cycle=summ["duty_cycle"],
         binding_ceiling_counts=summ["binding_ceiling_counts"],
         roofline_pct_mean=summ["roofline_pct_mean"], memory=summ["memory"],
         prometheus_lines=len(text.splitlines()), prometheus_samples=len(samples),
         unparsed_lines=bad, build_info=build_info(),
         suggest_ms={"with": times["with"], "without": times["without"]},
         suggest_p50_ms=p50, overhead_share=p50["with"] / p50["without"] - 1.0,
         device_s_over_host_s_median=float(np.median(
             [r["device_s"] / r["host_observed_s"] for r in rows])))
    assert len(rows) == n + 1 and stats.n_dispatches == n + 1
    assert launches["pair_score_batched"] == 2 * n and launches["fused_suggest"] == 2, launches
    assert all(r["binding_ceiling"] and r["device_s"] > 0 for r in rows), rows
    assert "fused" in rows[-1]["sig"] and not bad, bad
    assert summ["duty_cycle"] is not None and len(times["with"]) >= 8
    return p50


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


SERVICE_STUDIES = 4
SERVICE_ROUNDS = 8
DURABLE_HISTORY = 1000  # the kill -9 check's history: a smaller depth than N_HISTORY
DURABLE_FIRST, DURABLE_TOTAL = 6, 10


def hist_delta_quantiles(before, after):
    """p50 and p99 ms of the observations between two ``LatencyHistogram``
    states (the fixed buckets make a window an elementwise difference)."""
    from hyperopt_tpu_torch.observability import quantile_from_counts

    counts = [a - b for a, b in zip(after["counts"], before["counts"])]
    return {q: (None if not sum(counts) else
                1e3 * quantile_from_counts(after["edges"], counts, p))
            for q, p in (("p50_ms", 0.5), ("p99_ms", 0.99))}


def drive_clients(T, url, sids, rounds, concurrent):
    """Each study ``rounds`` suggest/report rounds over HTTP with the bench
    objective plus OBJECTIVE_SLEEP_S, one client thread per study at once
    (``concurrent``) or one study after another.  Returns wall seconds."""
    from hyperopt_tpu_torch.fmin import space_eval
    from hyperopt_tpu_torch.service import ServiceClient

    space = bench_space(T.hp)
    errors = []

    def run(sid):
        try:
            client = ServiceClient(url)
            for _ in range(rounds):
                (t,) = client.suggest(sid)
                cfg = space_eval(space, t["vals"])
                check_bench_values(cfg)
                time.sleep(OBJECTIVE_SLEEP_S)
                client.report(sid, t["tid"], loss=float(bench_objective(cfg)))
        except Exception as e:  # raised below, after every thread ended
            errors.append(e)

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=run, args=(sid,)) for sid in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "a client thread hung"
    else:
        for sid in sids:
            run(sid)
    wall = time.perf_counter() - t0
    assert not errors, errors
    return wall


def gated_batch(T, svc, sids, kw, around=contextlib.nullcontext):
    """Hold the scheduler (a ``call_soon`` task waiting on a gate), queue
    one suggest per study, release: ONE batched dispatch serves them all.
    ``around()`` is entered for the release and the wait only (a profiler
    then sees the batch and not the unbatched reference suggests).
    Returns (served payloads, the unbatched suggests' values from the same
    history and seed, pair-score launches of the dispatch, its wall s)."""
    import copy

    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    gate, results, errors = threading.Event(), {}, []
    svc.scheduler.call_soon(lambda: gate.wait(120))
    expected = {}
    for sid in sids:
        study = svc.registry.get(sid)
        with study.lock:  # the scheduler is held: nothing else touches it
            seed = int(copy.deepcopy(study.rstate).integers(2 ** 31 - 1))
            tid = max(study.trials._ids) + 1
            (doc,) = T.tpe.suggest([tid], study.domain, study.trials, seed, **kw)
        expected[sid] = {k: v[0] for k, v in doc["misc"]["vals"].items() if v}

    def call(sid):
        try:
            results[sid] = svc.suggest(sid, timeout=300)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=call, args=(sid,)) for sid in sids]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while len(svc.scheduler._queue) < len(sids) and time.monotonic() < deadline:
        time.sleep(0.01)
    try:
        assert len(svc.scheduler._queue) == len(sids), "suggests did not queue"
        before = svc.stats.summary()
        launches0 = pair_score_batched.launches
        with around():
            gate.set()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    after = svc.stats.summary()
    assert after["n_dispatches"] == before["n_dispatches"] + 1, (before, after)
    return (results, expected, pair_score_batched.launches - launches0,
            after["dispatch_s"] - before["dispatch_s"])


def spawn_service(root, port, log, *args):
    """``python -m hyperopt_tpu_torch.service --root ROOT --port PORT ARGS``
    (the card by default) as a process of its own, its output into ``log``."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen(
        [sys.executable, "-m", "hyperopt_tpu_torch.service", "--root", root,
         "--port", str(port), *args],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)


def stop_process(proc, sig=signal.SIGTERM, timeout=60):
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            raise
    return proc.returncode


def phase_service(T, counters):
    """The optimization service on the card, one replica: throughput of 4
    concurrent studies at the main path's size against the same studies one
    at a time, the batched dispatch's docs and launches, determinism against
    serial fmin, kill -9 recovery of a CLI server with an idempotent replay,
    fsck, and a warm restart from the compile ledger.  Returns the
    pair-score launches of the concurrent run."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch.fmin import space_eval
    from hyperopt_tpu_torch.service import (
        OptimizationService,
        ServiceClient,
        ServiceServer,
        free_port,
    )

    t_phase = time.perf_counter()
    kw = dict(n_EI_candidates=N_CAND)
    space = bench_space(T.hp)
    sids = [f"s{i}" for i in range(SERVICE_STUDIES)]
    svc = OptimizationService(root=None, device="cuda")
    server = ServiceServer(svc, port=free_port()).start()
    out = {}
    try:
        client = ServiceClient(server.url)
        client.wait_ready(timeout=120)
        for i, sid in enumerate(sids):
            client.create_study(sid, space, seed=i, algo="tpe", algo_params=kw)
            study = svc.registry.get(sid)
            with study.lock:
                prefilled_trials(T, N_HISTORY, seed=i, trials=study.trials)
        # (1) throughput: 4 client threads at once, then one at a time
        for name, concurrent in (("concurrent", True), ("one_at_a_time", False)):
            h0, s0 = svc.stats._suggest_hist.state(), svc.stats.summary()
            for c in counters:
                c.launches = 0
            wall = drive_clients(T, server.url, sids, SERVICE_ROUNDS, concurrent)
            launches = {c.__name__: c.launches for c in counters}
            h1, s1 = svc.stats._suggest_hist.state(), svc.stats.summary()
            n_disp = s1["n_dispatches"] - s0["n_dispatches"]
            n_batched = s1["n_batched_suggests"] - s0["n_batched_suggests"]
            out[name] = {
                "wall_ms_per_trial": wall * 1e3 / (len(sids) * SERVICE_ROUNDS),
                **hist_delta_quantiles(h0, h1), "dispatches": n_disp,
                "studies_per_dispatch": n_batched / n_disp,
                "pair_score_launches_per_dispatch": launches["pair_score_batched"] / n_disp,
                "launches": launches,
                "cold_suggests": s1["n_cold_suggests"] - s0["n_cold_suggests"]}
            emit("service", part=f"throughput_{name}", n_studies=len(sids),
                 rounds=SERVICE_ROUNDS, n_history=N_HISTORY, n_EI_candidates=N_CAND,
                 objective_sleep_s=OBJECTIVE_SLEEP_S, **out[name])
            assert launches["pair_score_batched"] == 2 * n_batched, (launches, n_batched)
        assert out["concurrent"]["studies_per_dispatch"] > 1.0, out
        # (2a) one batched dispatch of the 4 studies: each study's docs equal
        # its unbatched suggest, 2 launches per study; then the same batch
        # under torch.profiler for the device's busy share of it
        served, expected, n_launch, disp_s = gated_batch(T, svc, sids, kw)
        for sid in sids:
            assert served[sid][0]["vals"] == expected[sid], (sid, served[sid], expected[sid])
        assert n_launch == 2 * len(sids), n_launch
        prof = profile(activities=[ProfilerActivity.CUDA])
        _, _, _, prof_s = gated_batch(T, svc, sids, kw, around=lambda: prof)
        device_ms = sum(getattr(a, "self_device_time_total", 0.0) / 1e3
                        for a in prof.key_averages() if str(a.device_type).endswith("CUDA"))
        emit("service", part="batched_dispatch", docs_equal_unbatched=True,
             pair_score_launches=n_launch, dispatch_ms=disp_s * 1e3,
             profiled_dispatch_ms=prof_s * 1e3,
             device_ms=device_ms if device_ms else "not measured",
             device_busy_share=device_ms / (disp_s * 1e3) if device_ms else "not measured")
        # (2b) one study served serially over HTTP from the 10,000-trial
        # history equals serial fmin(tpe.suggest) at the same seed
        client.create_study("det", space, seed=7, algo="tpe", algo_params=kw)
        study = svc.registry.get("det")
        with study.lock:
            prefilled_trials(T, N_HISTORY, seed=7, trials=study.trials)
        got = []
        for _ in range(N_SUGGESTS):
            (t,) = client.suggest("det")
            got.append(t["vals"])
            client.report("det", t["tid"], loss=float(bench_objective(space_eval(space, t["vals"]))))
    finally:
        server.stop(timeout=120)
    trials = prefilled_trials(T, N_HISTORY, seed=7)
    T.fmin(bench_objective, space, algo=partial(T.tpe.suggest, **kw),
           max_evals=N_HISTORY + N_SUGGESTS, trials=trials, rstate=np.random.default_rng(7),
           show_progressbar=False, max_speculation=0)
    ref = [{k: v[0] for k, v in d["misc"]["vals"].items() if v} for d in trials.trials[N_HISTORY:]]
    emit("service", part="determinism", n_history=N_HISTORY, n_trials=len(got),
         trials_equal_serial_fmin=got == ref)
    assert got == ref, (got, ref)

    # (3) durability: the CLI server on the card, kill -9, respawn
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "service_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    root = os.path.join(base, "root")
    from hyperopt_tpu_torch.service import StudyRegistry

    reg = StudyRegistry(root, device="cuda")
    study = reg.create("dur", space, seed=11, algo_name="tpe", algo_params=kw)
    assert study.trials.new_trial_ids(DURABLE_HISTORY) == list(range(DURABLE_HISTORY))
    prefilled_trials(T, DURABLE_HISTORY, seed=11, trials=study.trials)
    del reg, study
    twin = prefilled_trials(T, DURABLE_HISTORY, seed=11)
    T.fmin(bench_objective, space, algo=partial(T.tpe.suggest, **kw),
           max_evals=DURABLE_HISTORY + DURABLE_TOTAL, trials=twin,
           rstate=np.random.default_rng(11), show_progressbar=False, max_speculation=0)
    twin_vals = [{k: v[0] for k, v in d["misc"]["vals"].items() if v}
                 for d in twin.trials[DURABLE_HISTORY:]]
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log = open(os.path.join(base, "server.log"), "w+")
    procs = []
    try:
        t0 = time.perf_counter()
        procs.append(spawn_service(root, port, log))
        client = ServiceClient(url, deadline=120.0, max_transport_retries=100,
                               backoff_max=0.5, breaker_threshold=50, breaker_cooldown=0.25)
        client.wait_ready(timeout=300)
        first_ready_s = time.perf_counter() - t0
        got, replay_bytes = [], None
        for i in range(DURABLE_FIRST):
            body = {"n": 1, "idempotency_key": f"dur-{i}"}
            status, raw = client._request("POST", "/v1/studies/dur/suggest", body, raw=True)
            assert status == 200, status
            (t,) = json.loads(raw)["trials"]
            replay_bytes = (body, raw)
            got.append(t["vals"])
            client.report("dur", t["tid"], loss=float(bench_objective(space_eval(space, t["vals"]))))
        procs[-1].send_signal(signal.SIGKILL)
        procs[-1].wait(timeout=60)
        t0 = time.perf_counter()
        procs.append(spawn_service(root, port, log))
        ready = client.wait_ready(timeout=300)
        respawn_ready_s = time.perf_counter() - t0
        assert ready["recovery"]["recovered_studies"] == 1, ready
        status, raw = client._request("POST", "/v1/studies/dur/suggest", replay_bytes[0],
                                      raw=True)
        assert status == 200 and raw == replay_bytes[1], (status, raw, replay_bytes[1])
        # (4) the respawned server warmed every ledger key before /readyz
        warm = client.warmup()
        for _ in range(DURABLE_TOTAL - DURABLE_FIRST):
            (t,) = client.suggest("dur")
            got.append(t["vals"])
            client.report("dur", t["tid"], loss=float(bench_objective(space_eval(space, t["vals"]))))
        st = client.service_status()["stats"]
        metrics = client.metrics()
        alerts = client.alerts()
        rc_term = stop_process(procs[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        log.close()
    emit("service", part="durability", n_history=DURABLE_HISTORY, killed_after=DURABLE_FIRST,
         n_trials=len(got), trials_equal_unkilled=got == twin_vals,
         replay_byte_identical=True, first_start_to_ready_s=first_ready_s,
         respawn_to_ready_s=respawn_ready_s, sigterm_exit=rc_term)
    assert got == twin_vals, (got, twin_vals)
    assert rc_term == 0, rc_term
    fsck = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service", "fsck", root],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(
                              os.path.abspath(__file__))))
    emit("service", part="fsck", exit=fsck.returncode, report=fsck.stdout.strip()[-200:])
    assert fsck.returncode == 0 and fsck.stdout.strip().endswith("clean"), fsck.stdout
    states = [i["state"] for i in warm["items"]]
    metric_rows = [m for m in ("hyperopt_service_suggest_duration_seconds_bucket",
                               "hyperopt_device_dispatches_total",
                               "hyperopt_device_roofline_pct") if m in metrics]
    emit("service", part="warm_restart", warmup_items=len(states), warmup_states=states,
         warmup_from_ledger=sum(i["source"] == "ledger" for i in warm["items"]),
         cold_suggests=st["n_cold_suggests"], cold_after_ready=st["n_cold_after_ready"],
         metrics_rows=metric_rows, slo_breaching=alerts["breaching"],
         slo_rules={r["rule"]: r["status"] for r in alerts["rules"]})
    assert states and all(s == "warm" for s in states), warm
    assert any(i["source"] == "ledger" for i in warm["items"]), warm
    assert st["n_cold_suggests"] == 0 and st["n_cold_after_ready"] == 0, st
    assert len(metric_rows) == 3, metric_rows
    assert alerts["breaching"] == [], alerts["breaching"]
    emit("service", part="seconds", seconds=time.perf_counter() - t_phase)
    return out["concurrent"]["launches"]


REPLICA_TTL = 3.0  # heartbeats every 1 s: margin for a launch-heavy scheduler
REPLICA_ROUNDS = 4  # suggest/report rounds per study before the kill, and after it


def spread_names(ring, urls, per_url, prefix):
    """Study ids whose ring primaries cover ``urls`` ``per_url`` times each."""
    want = {u: per_url for u in urls}
    names, i = [], 0
    while sum(want.values()):
        sid = f"{prefix}-{i}"
        i += 1
        if want.get(ring.primary(sid), 0) > 0:
            want[ring.primary(sid)] -= 1
            names.append(sid)
        assert i < 10_000, "the ring never covered the requested spread"
    return names


def metric_value(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{name} not on /metrics")


def suggest_hist(text):
    """(edges, per-bucket counts) of the suggest-latency histogram on
    ``/metrics`` (cumulative buckets in the exposition)."""
    edges, cum = [], []
    for line in text.splitlines():
        if line.startswith("hyperopt_service_suggest_duration_seconds_bucket"):
            le = line.split('le="')[1].split('"')[0]
            cum.append(int(float(line.split()[-1])))
            if le != "+Inf":
                edges.append(float(le))
    return edges, [c - p for c, p in zip(cum, [0] + cum[:-1])]


def drive_replica_clients(T, client, sids, rounds, served, concurrent=True):
    """``rounds`` suggest/report rounds per study through one multi-replica
    client, one thread per study (``concurrent``) or one study after
    another; the bench objective plus OBJECTIVE_SLEEP_S.  Appends each
    served value dict to ``served[sid]``; returns, per study, the wall
    times its first and its last suggest returned and the seconds its
    first suggest call took (``{sid: {"first", "last", "first_call_s"}}``),
    and the phase's wall seconds."""
    from hyperopt_tpu_torch.fmin import space_eval

    space, errors, marks = bench_space(T.hp), [], {}

    def run(sid):
        try:
            for i in range(rounds):
                t_call = time.perf_counter()
                (t,) = client.suggest(sid)
                t_back = time.perf_counter()
                if i == 0:
                    marks[sid] = {"first": t_back, "first_call_s": t_back - t_call}
                marks[sid]["last"] = t_back
                served[sid].append(t["vals"])
                cfg = space_eval(space, t["vals"])
                check_bench_values(cfg)
                time.sleep(OBJECTIVE_SLEEP_S)
                client.report(sid, t["tid"], loss=float(bench_objective(cfg)))
        except Exception as e:  # raised below, after every thread ended
            errors.append(e)

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=run, args=(sid,)) for sid in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "a client thread hung"
    else:
        for sid in sids:
            run(sid)
    assert not errors, errors
    return marks, time.perf_counter() - t0


def phase_replica_failover(T):
    """Two CLI replicas on one root and one card: 4 studies split by the
    ring, ``kill -9`` of one replica, its studies adopted by the survivor
    (fsck-clean, pre-warmed, served warm), every trajectory equal to a
    single-replica twin.  Returns the survivor's kernel launches in the
    run after the kill."""
    from hyperopt_tpu_torch.observability import quantile_from_counts
    from hyperopt_tpu_torch.service import ServiceClient, StudyRegistry, free_port
    from hyperopt_tpu_torch.service.replicas import ReplicaDirectory, StudyLeaseStore

    t_phase = time.perf_counter()
    kw = dict(n_EI_candidates=N_CAND)
    space = bench_space(T.hp)
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, "build", "replica_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    root = os.path.join(base, "root")
    ports = [free_port(), free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    rids = ["r1", "r2"]
    log = open(os.path.join(base, "replicas.log"), "w+")
    procs = []

    def start_both():
        t0 = time.perf_counter()
        # the default kernel-library directory: two replicas share its build
        new = [spawn_service(root, p, log, "--replica-id", rid, "--advertise-url",
                             f"http://127.0.0.1:{p}", "--replica-ttl", str(REPLICA_TTL))
               for p, rid in zip(ports, rids)]
        procs.extend(new)
        for u in urls:
            ServiceClient(u).wait_ready(timeout=300)
        return new, time.perf_counter() - t0

    try:
        # (1) the ring splits 4 studies over two replicas at create time
        first, start_s = start_both()
        client = ServiceClient(replicas=urls, deadline=120.0, retry_timeout=120.0,
                               backoff_base=0.02, backoff_max=0.2, retry_seed=7)
        sids = spread_names(client.ring, urls, 2, prefix="fo")
        seeds = {sid: 20 + i for i, sid in enumerate(sids)}
        for sid in sids:
            client.create_study(sid, space, seed=seeds[sid], algo="tpe", algo_params=kw)
        owner = {sid: rid for u, rid in zip(urls, rids)
                 for sid in ServiceClient(u).replicas()["owned_studies"]}
        assert sorted(owner) == sorted(sids), owner
        assert [sum(o == rid for o in owner.values()) for rid in rids] == [2, 2], owner
        # (2) SIGTERM both: each releases its leases (fence kept) and withdraws
        rcs = [stop_process(p) for p in first]
        leases = StudyLeaseStore(root)
        released = [leases.read(sid) for sid in sids]
        assert rcs == [0, 0] and all(
            r["owner"] is None and r["fence"] >= 1 for r in released), (rcs, released)
        assert ReplicaDirectory(root).replicas() == []
        # (3) the studies' durable directories get the history offline; the
        # leases go back to their owners for the restart
        history = N_HISTORY
        reg = StudyRegistry(root, device="cuda")
        for sid in sids:
            study = reg.get(sid)
            assert study.trials.new_trial_ids(history) == list(range(history))
            prefilled_trials(T, history, seed=seeds[sid], trials=study.trials)
        del reg, study
        for sid in sids:
            assert leases.claim(sid, owner[sid], ttl=600.0) is not None
        procs.clear()  # both exited
        _, restart_s = start_both()
        emit("replica_failover", part="setup", n_history=history,
             history_choice="N_HISTORY", studies=sids, owners=owner,
             replica_ttl_s=REPLICA_TTL, first_start_to_ready_s=start_s,
             restart_to_ready_s=restart_s, graceful_release=True)
        # (4) 4 concurrent rounds, then kill -9 of r1
        served = {sid: [] for sid in sids}
        pre, wall_pre = drive_replica_clients(T, client, sids, REPLICA_ROUNDS, served)
        victims = sorted(s for s in sids if owner[s] == "r1")
        survivors = sorted(s for s in sids if owner[s] == "r2")
        r2 = ServiceClient(urls[1])
        expiry = {sid: leases.read(sid)["expires_at"] for sid in victims}
        st0, m0 = r2.service_status(), r2.metrics()
        t_kill_wall, t_kill = time.time(), time.perf_counter()
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=60)
        # (5) the first suggest of every study after the kill, one at a time
        # (the migrated ones first): none is a compile event on r2
        first_post, wall_first = drive_replica_clients(
            T, client, victims + survivors, 1, served, concurrent=False)
        st1 = r2.service_status()
        # (6) the remaining rounds, 4 clients at once
        _, wall_post = drive_replica_clients(T, client, sids, REPLICA_ROUNDS - 1, served)
        st2, m2, doc = r2.service_status(), r2.metrics(), r2.replicas()
        # SL608 needs an SLO window of 30 s on r2
        while st2["uptime_s"] < 32.0:
            time.sleep(0.5)
            st2 = r2.service_status()
        alerts = r2.alerts()
        statuses = {sid: client.study_status(sid) for sid in sids}
        rc_term = stop_process(procs[1])
        after_term = [leases.read(sid) for sid in sids]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        log.close()
    # the twins: each study alone, on the card, at the same seed and history
    twins = {}
    for sid in sids:
        trials = prefilled_trials(T, history, seed=seeds[sid])
        T.fmin(bench_objective, space, algo=partial(T.tpe.suggest, **kw),
               max_evals=history + 2 * REPLICA_ROUNDS, trials=trials,
               rstate=np.random.default_rng(seeds[sid]), show_progressbar=False,
               max_speculation=0)
        twins[sid] = [{k: v[0] for k, v in d["misc"]["vals"].items() if v}
                      for d in trials.trials[history:]]
    takeovers = {r["study_id"]: r for r in doc["stats"]["recent_takeovers"]}
    launches = {name: st2["kernel_launches"][name] - st0["kernel_launches"][name]
                for name in st0["kernel_launches"]}
    first_launches = (st1["kernel_launches"]["pair_score_batched"]
                      - st0["kernel_launches"]["pair_score_batched"])
    edges, c0 = suggest_hist(m0)
    _, c2 = suggest_hist(m2)
    window = [b - a for a, b in zip(c0, c2)]
    for sid in victims:
        rec = takeovers[sid]
        emit("replica_failover", part="takeover", study=sid, from_owner=rec["from_owner"],
             reason=rec["reason"], fence=rec["fence"], ok=rec["ok"],
             fsck_clean=rec["fsck_clean"], prewarm=rec["prewarm"],
             duration_s=rec["duration_s"], split_s=rec["split_s"],
             kill_to_lease_expiry_s=expiry[sid] - t_kill_wall,
             client_gap_s=first_post[sid]["first"] - pre[sid]["last"],
             kill_to_first_suggest_s=first_post[sid]["first"] - t_kill,
             first_suggest_call_s=first_post[sid]["first_call_s"])
    n_trials = 2 * REPLICA_ROUNDS
    emit("replica_failover", part="serving", n_history=history,
         wall_ms_per_trial_before=wall_pre * 1e3 / (len(sids) * REPLICA_ROUNDS),
         wall_ms_per_trial_after=(wall_first + wall_post) * 1e3 / (len(sids) * REPLICA_ROUNDS),
         wall_ms_per_trial_after_concurrent=wall_post * 1e3 / (len(sids) * (REPLICA_ROUNDS - 1)),
         r2_suggest_p50_ms_after=1e3 * quantile_from_counts(edges, window, 0.5),
         r2_suggest_p99_ms_after=1e3 * quantile_from_counts(edges, window, 0.99),
         r2_kernel_launches_after=launches, r2_launches_first_suggests=first_launches,
         r2_prewarm_launches=first_launches - 2 * len(sids),
         r2_cold_first_suggests=(st1["stats"]["n_cold_suggests"]
                                 - st0["stats"]["n_cold_suggests"]),
         r2_cold_after=st2["stats"]["n_cold_suggests"] - st0["stats"]["n_cold_suggests"],
         r2_owned=doc["owned_studies"],
         renew_lost=metric_value(m2, "hyperopt_replica_lease_renew_lost_total"),
         stale_writes_dropped=metric_value(m2, "hyperopt_replica_stale_writes_dropped_total"),
         sl608=[r["status"] for r in alerts["rules"] if r["rule"] == "SL608"],
         trials_equal_twin={sid: served[sid] == twins[sid] for sid in sids},
         sigterm_exit=rc_term)
    # the checks
    assert sorted(doc["owned_studies"]) == sorted(sids), doc["owned_studies"]
    assert sorted(takeovers) == victims, takeovers
    for sid in victims:
        rec = takeovers[sid]
        assert rec["ok"] and rec["fsck_clean"] and sum(rec["prewarm"].values()) > 0, rec
        assert rec["duration_s"] < 30.0, rec  # the reference's MTTR bound
    assert st1["stats"]["n_cold_suggests"] == st0["stats"]["n_cold_suggests"], (st0, st1)
    # r2 served the 4 first suggests on the card (2 launches each), after
    # whatever its takeovers' pre-warm launched
    assert first_launches >= 2 * len(sids), first_launches
    for sid in sids:
        st = statuses[sid]
        assert st["n_trials"] == st["n_completed"] == history + n_trials, st
        assert served[sid] == twins[sid], (sid, served[sid], twins[sid])
    assert metric_value(m2, "hyperopt_replica_lease_renew_lost_total") == 0
    assert metric_value(m2, "hyperopt_replica_stale_writes_dropped_total") == 0
    assert [r["status"] for r in alerts["rules"] if r["rule"] == "SL608"] == ["ok"], alerts
    assert rc_term == 0 and all(r["owner"] is None for r in after_term), (rc_term, after_term)
    fsck = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service", "fsck", root,
                           "--json"], capture_output=True, text=True, timeout=300, cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo))
    report = json.loads(fsck.stdout) if fsck.returncode in (0, 1) else {}
    n_leases = sum(n.endswith(".lease") for n in os.listdir(leases.leases_dir))
    emit("replica_failover", part="fsck", exit=fsck.returncode, clean=report.get("clean"),
         n_queues=report.get("n_queues"), n_docs=report.get("n_docs"),
         replica_plane_leases_checked=n_leases)
    assert fsck.returncode == 0 and report["clean"] and n_leases == len(sids), fsck.stdout
    emit("replica_failover", part="seconds", seconds=time.perf_counter() - t_phase)
    return launches


# tests/test_mesh.py's space and algo parameters, and the virtual meshes
# the mesh phase lays on the one card (each slot its own stream)
MESH_SPACE_AP = {"n_startup_jobs": 4, "n_EI_candidates": 32}
MESH_SHAPES = [(1, 2), (2, 1), (2, 2)]


def mesh_space(hp):
    return {"x": hp.uniform("x", -5, 5), "c": hp.choice("c", ["a", "b"]),
            "w": hp.quniform("w", 0, 10, 1)}


def mesh_objective(c):
    return (c["x"] - 1.0) ** 2 + (0.5 if c["c"] == "b" else 0.0) + 0.1 * c["w"]


def virtual_mesh(shape):
    from hyperopt_tpu_torch.parallel.sharding import DeviceMesh

    return DeviceMesh(["cuda:0"] * (shape[0] * shape[1]), shape=shape)


def hold_partials():
    """The partials launch against its plain version (both regions) at the
    main path's shape and a small ragged one, its difference against the
    pair-score kernel bit for bit, and the combine of sp = 1, 2, 4 shards
    against the unsharded kernel: each within TOLERANCE."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials, pair_score_batched
    from hyperopt_tpu_torch.ops.score import pair_lse_partials as plain_partials
    from hyperopt_tpu_torch.ops.score import pair_score
    from hyperopt_tpu_torch.parallel import sharding

    main_err = None
    for name in ("main", "ragged"):
        shape = MAIN_SHAPE if name == "main" else EDGE_SHAPES["ragged"]
        z, params = pair_case(seed=len(name) + 7, **shape)
        kb = shape["kb"]
        got = pair_lse_partials(z, params, kb)
        scores = pair_score_batched(z, params, kb)
        ref = plain_partials(z, params, kb)
        ref64 = plain_partials(z.double(), params.double(), kb)
        torch.cuda.synchronize()
        allow, plain_err = allowance(ref, ref64)
        err = (got - ref).abs()
        row = {"max_abs_err": float(err.max()), "plain_vs_f64_err": plain_err,
               "ok": bool((err <= allow).all()) and bool(torch.isfinite(got).all()),
               "difference_bitwise_equals_kernel": bool(torch.equal(
                   (got[0] - got[1]).view(torch.int32), scores.view(torch.int32)))}
        s_ref, s_ref64 = pair_score(z, params, kb), pair_score(z.double(), params.double(), kb)
        s_allow, _ = allowance(s_ref, s_ref64)
        for sp in (1, 2, 4):
            shards, wb = sharding._region_shards(params, kb, sp)
            combined = sharding.lse_combine([pair_lse_partials(z, p, wb) for p in shards])
            e = (combined[0] - combined[1] - scores).abs()
            row[f"combine_sp{sp}_vs_kernel_err"] = float(e.max())
            row["ok"] = row["ok"] and bool((e <= s_allow).all())
        row["ok"] = row["ok"] and row["difference_bitwise_equals_kernel"]
        emit("mesh", part="partials_vs_plain", shape=name, **shape, **row, tolerance=TOLERANCE)
        assert row["ok"], (name, row)
        if name == "main":
            main_err = row["max_abs_err"]
    return main_err


def mesh_winners(T, domain, trials, seed, mesh=None):
    docs = T.tpe.suggest([N_HISTORY], domain, trials, seed, n_EI_candidates=N_CAND, mesh=mesh)
    return {k: v[0] for k, v in docs[0]["misc"]["vals"].items()}


def mesh_near_tie(T, domain, trials, seed, label, a, b):
    """The plain scores on the card of the suggest's own candidates for
    ``label``: the gap between the two winners ``a`` and ``b`` against
    twice the per-score TOLERANCE (each scorer is within one TOLERANCE of
    the plain version, so their argmaxes can differ only where the plain
    scores of the two winners are that close)."""
    cands, s = T.tpe.plain_label_scores([N_HISTORY], domain, trials, seed, label,
                                        device="cuda", n_EI_candidates=N_CAND)
    _, s64 = T.tpe.plain_label_scores([N_HISTORY], domain, trials, seed, label,
                                      dtype=torch.float64, device="cuda",
                                      n_EI_candidates=N_CAND)
    pick = [int(np.argmin(np.abs(cands[0] - a))), int(np.argmin(np.abs(cands[0] - b)))]
    allow, _ = allowance(torch.from_numpy(s[0, pick]), torch.from_numpy(s64[0, pick]))
    return {"seed": seed, "label": label, "unsharded": a, "sharded": b,
            "gap": float(abs(s[0, pick[0]] - s[0, pick[1]])), "allow": 2 * float(allow.min())}


def process_state(where):
    """What else runs beside the script, printed at ``where``: the live
    threads (a trailing ``*`` marks a daemon), every other Python process
    on the machine with its command line, the suggest plane's observers, whether
    an autograd profiler is on, the Python heap's object count, the
    caching allocator's counters, the card's clocks, power and use, the
    host µs of one small CUDA op (2,000 in-place adds: a slow-down of op
    dispatch) and the event ms of the pair-score kernel at the main shape
    (20 launches: a slow-down of the card)."""
    from hyperopt_tpu_torch.algos import tpe_device
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    threads = [t.name + ("*" if t.daemon else "") for t in threading.enumerate()
               if t is not threading.main_thread()]
    others = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if "python" in cmd.split(" ")[0]:
            others[pid] = cmd[:120]
    on = getattr(torch._C._autograd, "_profiler_enabled", lambda: None)()
    mem = torch.cuda.memory_stats()
    allocator = {k: mem.get(k) for k in (
        "allocated_bytes.all.current", "reserved_bytes.all.current", "segment.all.current",
        "active.all.current", "num_alloc_retries", "num_device_alloc", "num_device_free",
        "num_sync_all_streams")}
    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    op_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    z, params = pair_case(seed=3, **MAIN_SHAPE)
    kernel_ms = cuda_ms(lambda: pair_score_batched(z, params, MAIN_SHAPE["kb"]), 20)
    emit("process_state", where=where, threads=threads, other_processes=others,
         suggest_observers=len(tpe_device._suggest_observers),
         trace_observers=len(tpe_device._trace_observers), autograd_profiler_on=on,
         gc_objects=len(gc.get_objects()), allocator=allocator,
         card=nvidia_smi("clocks.sm,clocks.mem,power.draw,temperature.gpu,utilization.gpu,"
                         "memory.used"),
         op_host_us=op_us, probe_kernel_ms=kernel_ms, loadavg=os.getloadavg())


@contextlib.contextmanager
def stage_timers(targets):
    """Host ms spent in each ``(module, name)`` of ``targets``: each is
    wrapped to add its wall time to ``totals[name]`` (inclusive of the
    stages it calls) and to mark a ``torch.profiler`` range of that name;
    the originals are put back on exit."""
    totals = {name: 0.0 for _, name in targets}
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(_name):
                    return _fn(*args, **kwargs)
            finally:
                totals[_name] += (time.perf_counter() - t0) * 1e3

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield totals
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_suggest(suggest, labels):
    """One suggest under ``torch.profiler`` (host and card): host ms of
    each range in ``labels``, the count of each CUDA runtime call the
    suggest made, the card's busy ms (the sum of its kernels' and
    copies' device time) and its busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        suggest()
        torch.cuda.synchronize()
    host, calls, kernels = {}, {}, {}
    for a in prof.key_averages():
        if a.key in labels:
            # a range has a host entry and a card-side annotation that
            # spans its kernels: only the host one is read
            if a.device_type == DeviceType.CPU:
                host[a.key] = a.cpu_time_total / 1e3
        elif a.device_type == DeviceType.CUDA:
            kernels[a.key] = (a.self_device_time_total / 1e3, a.count)
        elif a.key.startswith("cuda") and a.key[4:5].isupper():
            calls[a.key] = a.count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return {"host_ms": host, "runtime_calls": calls,
            "device_busy_ms": sum(ms for ms, _ in kernels.values()),
            "device_launches": sum(n for _, n in kernels.values()),
            "top_kernels": [{"kernel": k[:80], "ms": ms, "count": n} for k, (ms, n) in top]}


def phase_mesh(T, counters):
    """Mesh execution on the one card: the partials launch held, the
    degenerate mesh, virtual meshes (1x2, 2x1, 2x2 slots on cuda:0, each
    its own stream) against the unsharded kernel path, the mesh's main
    path at the 10,000-trial history, a one-rank NCCL group, and
    TorchTrials' device plane split over dp."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials, pair_score_batched
    from hyperopt_tpu_torch.parallel import distributed, sharding

    t_phase = time.perf_counter()
    process_state("mesh_start")
    err = hold_partials()

    # degenerate: one card's "auto" is the single-device program
    auto = sharding.DeviceMesh.auto()
    assert auto.grid is None and sharding.resolve_mesh(auto) is None, auto
    trials = prefilled_trials(T, N_HISTORY)
    domain = T.Domain(bench_objective, bench_space(T.hp))
    runs = {}
    for mesh in (None, "auto"):
        for c in counters:
            c.launches = 0
        runs[mesh] = (mesh_winners(T, domain, trials, 0, mesh),
                      {c.__name__: c.launches for c in counters})
    emit("mesh", part="degenerate", auto_grid=None, docs_equal=runs[None][0] == runs["auto"][0],
         launches_none=runs[None][1], launches_auto=runs["auto"][1])
    assert runs[None] == runs["auto"], runs

    # virtual meshes against the unsharded kernel path, 8 seeds
    unsharded = {seed: mesh_winners(T, domain, trials, seed) for seed in range(8)}
    z, params = pair_case(seed=11, **MAIN_SHAPE)
    kb = MAIN_SHAPE["kb"]
    kernel_ms = cuda_ms(lambda: pair_score_batched(z, params, kb), 50)
    fan = {}
    for shape in MESH_SHAPES:
        mesh = virtual_mesh(shape)
        pairs, close, ties = 0, 0, []
        for seed in range(8):
            got = mesh_winners(T, domain, trials, seed, mesh)
            for lb, v in unsharded[seed].items():
                pairs += 1
                if np.isclose(got[lb], v, rtol=1e-5):
                    close += 1
                else:
                    ties.append(mesh_near_tie(T, domain, trials, seed, lb, v, got[lb]))
        outside = [t for t in ties if not t["gap"] <= t["allow"]]
        # the same fmin, trial for trial, with and without the mesh
        tr = {}
        for m in (None, mesh):
            tr[m] = T.Trials()
            T.fmin(mesh_objective, mesh_space(T.hp),
                   algo=partial(T.tpe.suggest, mesh=m, **MESH_SPACE_AP), max_evals=16,
                   trials=tr[m], rstate=np.random.default_rng(11), show_progressbar=False,
                   max_speculation=0)
        same = [a["misc"]["vals"] == b["misc"]["vals"]
                for a, b in zip(tr[None].trials, tr[mesh].trials)]
        score = sharding.make_sharded_pair_score_batched(mesh)
        for c in counters:
            c.launches = 0
        score(z, params, kb)
        torch.cuda.synchronize()
        per_call = pair_lse_partials.launches
        fan[shape] = cuda_ms(lambda: score(z, params, kb), 50)
        gc.collect()
        gc.disable()  # the same timing without the collector's pauses
        try:
            fan_gc_off = cuda_ms(lambda: score(z, params, kb), 50)
        finally:
            gc.enable()
        emit("mesh", part="virtual", mesh=mesh.shape_str, slots=mesh.n_devices,
             seeds=8, pairs=pairs, equal=close, mismatches=ties, outside_allowance=outside,
             fmin_trials=len(same), fmin_equal=sum(same), launches_per_scorer_call=per_call,
             sharded_ms=fan[shape], sharded_ms_gc_off=fan_gc_off,
             unsharded_kernel_ms=kernel_ms, shape=MAIN_SHAPE,
             tolerance="each mismatch a near-tie: |plain gap| <= 2 x TOLERANCE")
        assert not outside and len(same) == 16 and all(same), (shape, outside, same)
        assert per_call == shape[0] * shape[1], per_call

    # the mesh's main path: fmin at the 10,000-trial history on 2x2, the
    # counts set to 0 just before and read just after; the same fmin
    # without a mesh first, in the same process state, as its control.
    # Each suggest's host ms split by stage (inclusive: the pair apply
    # holds the blocks, shards, fan-out, combine and assemble)
    from hyperopt_tpu_torch.algos import tpe_device

    stages = [(tpe_device, "_family_suggest_core"), (tpe_device, "_sharded_pair_apply"),
              (tpe_device, "pair_score_batched"), (sharding, "_blocks"),
              (sharding, "_region_shards"), (sharding, "run_on_slots"),
              (sharding, "_combine_rows"), (sharding, "_assemble"), (sharding, "dp_apply")]

    def drive(mesh_, trials_):
        times, splits = [], []
        with stage_timers(stages) as totals:
            def timed_suggest(new_ids, domain_, tr, seed):
                before = dict(totals)
                t0 = time.perf_counter()
                docs = T.tpe.suggest(new_ids, domain_, tr, seed, n_EI_candidates=N_CAND,
                                     mesh=mesh_)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                splits.append({k: totals[k] - before[k] for k in totals})
                return docs

            T.fmin(bench_objective, bench_space(T.hp), algo=timed_suggest,
                   max_evals=N_HISTORY + N_SUGGESTS, trials=trials_,
                   rstate=np.random.default_rng(0), show_progressbar=False)
        steady = {k: float(np.median([sp[k] for sp in splits[1:]])) for k in splits[0]}
        return times, {k: v for k, v in steady.items() if v > 0}

    process_state("mesh_before_main_path")
    control_times, control_split = drive(None, prefilled_trials(T, N_HISTORY))
    mesh = virtual_mesh((2, 2))
    trials = prefilled_trials(T, N_HISTORY)
    for c in counters:
        c.launches = 0
    times, split = drive(mesh, trials)
    launches = {c.__name__: c.launches for c in counters}
    for doc in trials.trials[N_HISTORY:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
        assert math.isfinite(doc["result"]["loss"])
    emit("mesh", part="main_path", mesh="2x2", n_history=N_HISTORY, n_suggests=N_SUGGESTS,
         launches=launches, launches_per_suggest=launches["pair_lse_partials"] / N_SUGGESTS,
         suggest_ms_first=times[0], suggest_ms_steady=float(np.median(times[1:])),
         stage_host_ms_steady=split,
         control_no_mesh_ms_first=control_times[0],
         control_no_mesh_ms_steady=float(np.median(control_times[1:])),
         control_stage_host_ms_steady=control_split)
    # 2 unquantized families per suggest, one launch per slot each
    assert launches["pair_lse_partials"] == 2 * 4 * N_SUGGESTS, launches
    assert launches["pair_score_batched"] == 0 and launches["fused_suggest"] == 0, launches

    # one steady suggest each way under torch.profiler, on the same history
    labels = {name for _, name in stages}
    traced = {}
    domain = T.Domain(bench_objective, bench_space(T.hp))
    for key, m in (("no_mesh", None), ("2x2", mesh)):
        def one(m=m):
            T.tpe.suggest([len(trials.trials)], domain, trials, 5, n_EI_candidates=N_CAND, mesh=m)

        with stage_timers(stages):
            one()  # warm: this mesh's history mirror of these trials
            traced[key] = profile_suggest(one, labels)
        # the same suggest's host ms with the garbage collector on and off
        for mode in ("gc_on", "gc_off"):
            ms = []
            gc.collect()
            if mode == "gc_off":
                gc.disable()
            try:
                for _ in range(3):
                    t0 = time.perf_counter()
                    one()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                gc.enable()
            traced[key][f"suggest_ms_{mode}"] = float(np.median(ms))
    emit("mesh", part="suggest_trace", n_history=len(trials.trials), **traced)

    # one-rank NCCL: the collectives the sp combine uses across processes
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                                  process_id=0, timeout=datetime.timedelta(seconds=120))
    try:
        backend = torch.distributed.get_backend()
        x = torch.tensor([1.5, -2.0, 3.25], device="cuda")
        mx, sm = x.clone(), x.clone()
        torch.distributed.all_reduce(mx, torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(sm, torch.distributed.ReduceOp.SUM)
        torch.cuda.synchronize()
        gm = distributed.global_mesh()
        ok = (bool(torch.equal(mx, x)) and bool(torch.equal(sm, x)) and gm.grid is None
              and gm.ranks == (0,) and distributed.is_coordinator())
    finally:
        torch.distributed.destroy_process_group()
    emit("mesh", part="nccl_one_rank", backend=backend, all_reduce_ok=ok,
         global_mesh=repr(gm), port=port)
    assert backend == "nccl" and ok

    # TorchTrials' device plane split over dp=2 of a virtual 2x1 mesh
    from hyperopt_tpu_torch.models import domains

    d = domains.get("branin")
    tt = T.TorchTrials(parallelism=8, device_fn=branin_torch, mesh=virtual_mesh((2, 1)))
    T.fmin(d.fn, d.space, algo=partial(T.rand.suggest), max_evals=64, trials=tt,
           rstate=np.random.default_rng(0), show_progressbar=False)
    batch = {k: torch.tensor([t["misc"]["vals"][k][0] for t in tt.trials], device="cuda",
                             dtype=torch.float32) for k in ("x", "y")}
    plain = torch.func.vmap(branin_torch)(batch).cpu().numpy()
    got = np.array([t["result"]["loss"] for t in tt.trials])
    sharded = sharding.make_sharded_batch_eval(virtual_mesh((2, 1)), branin_torch)(batch)
    equal_direct = bool(torch.equal(sharded.cpu(), torch.from_numpy(plain)))
    worst = float(np.max(np.abs(got - plain) / np.abs(plain)))
    emit("mesh", part="torch_trials", mesh="2x1", n_evals=len(tt.trials),
         device_batches=tt.device_batches, host_trials=tt.host_trials,
         worst_rel_vs_unsharded=worst, batch_eval_bitwise_equal=equal_direct)
    assert len(tt.trials) == 64 and tt.device_batches > 0 and tt.host_trials == 0
    assert worst <= 1e-6 and equal_direct, (worst, equal_direct)
    emit("mesh", part="seconds", seconds=time.perf_counter() - t_phase)
    return err, launches["pair_lse_partials"]


def phase_self_lint():
    """The port's own self-lint over ``hyperopt_tpu_torch/`` on this
    machine (no JAX): race, durability, static program and protocol
    passes and the small-scope protocol model check; no error finding.
    Each section's findings and seconds."""
    from hyperopt_tpu_torch.analysis import Severity, run_self_lint

    t0 = time.perf_counter()
    sections = run_self_lint()
    rows = {key: {"findings": len(ds), "errors": sum(d.severity == Severity.ERROR for d in ds),
                  "seconds": secs} for key, _, ds, secs in sections}
    found = [d.format() for _, _, ds, _ in sections for d in ds]
    emit("self_lint", sections=rows, findings=found[:20], seconds=time.perf_counter() - t0)
    assert not any(r["errors"] for r in rows.values()), found


AUDIT_TRIALS = 200


def phase_recompile_audit(T, counters):
    """``audit_tpe_run`` on the card for 200 trials (the probe space: one
    continuous family of 2 labels and one index family; 20 startup
    trials): no PL205, the compile events per trial-count bucket, and the
    pair-score kernel launched once per TPE suggest."""
    from hyperopt_tpu_torch.analysis import audit_tpe_run

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    aud = audit_tpe_run(n_trials=AUDIT_TRIALS, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    diags = aud.diagnostics()
    emit("recompile_audit", n_trials=AUDIT_TRIALS, compile_events=aud.n_traces,
         program_keys=aud.n_programs, events_per_bucket=aud.bucket_summary(),
         pl205=[d.format() for d in diags], launches=launches, seconds=seconds)
    assert not diags, [d.format() for d in diags]
    assert aud.n_traces >= 1
    assert launches["pair_score_batched"] == AUDIT_TRIALS - 20, launches
    return launches


CHECKPOINT_TRIALS = (8, 16)


def phase_checkpoint(T, counters):
    """``fmin(trials_save_file=<dir>/run.orbax)`` at the main path's
    history: 8 trials, then resumed in a fresh ``Trials`` to 16 with the
    same ``rstate`` stream, trial for trial an uninterrupted 16-trial run;
    the newest step's payload truncated, restore falls back to the step
    before.  Save ms per step during the run; at 10,000 trials the step's
    bytes and save ms beside the pickle path's."""
    from hyperopt_tpu_torch.checkpoint import TrialsCheckpointer, atomic_pickle_dump

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "checkpoint_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "run.orbax")
    space = bench_space(T.hp)
    algo = partial(T.tpe.suggest, n_EI_candidates=N_CAND)
    n1, n2 = CHECKPOINT_TRIALS
    save_ms, real_save = [], TrialsCheckpointer.save

    def timed_save(self, trials):
        t0 = time.perf_counter()
        out = real_save(self, trials)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    rstate = np.random.default_rng(0)
    TrialsCheckpointer.save = timed_save
    try:
        for c in counters:
            c.launches = 0
        T.fmin(bench_objective, space, algo=algo, max_evals=N_HISTORY + n1,
               trials=prefilled_trials(T, N_HISTORY), trials_save_file=path, rstate=rstate,
               show_progressbar=False)
        resumed = T.Trials()
        T.fmin(bench_objective, space, algo=algo, max_evals=N_HISTORY + n2, trials=resumed,
               trials_save_file=path, rstate=rstate, show_progressbar=False)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        TrialsCheckpointer.save = real_save
    whole = prefilled_trials(T, N_HISTORY)
    T.fmin(bench_objective, space, algo=algo, max_evals=N_HISTORY + n2, trials=whole,
           rstate=np.random.default_rng(0), show_progressbar=False)
    same = [a == b for a, b in zip(suggested(resumed), suggested(whole))]
    steps = TrialsCheckpointer(path).steps()
    newest = os.path.join(path, str(steps[-1]), "default", "metadata")
    step_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                     os.walk(os.path.join(path, str(steps[-1]))) for f in fs)
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    fallback = TrialsCheckpointer(path).restore()
    fell_back = [d["misc"]["vals"] for d in fallback.trials] == \
        [d["misc"]["vals"] for d in resumed.trials[:-1]]
    # one save of the 10,000-trial history each way, 3 times
    base = prefilled_trials(T, N_HISTORY)
    orbax_ms, pickle_ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        TrialsCheckpointer(os.path.join(root, f"at10k_{i}.orbax")).save(base)
        orbax_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        atomic_pickle_dump(base, os.path.join(root, f"at10k_{i}.pkl"))
        pickle_ms.append((time.perf_counter() - t0) * 1e3)
    at10k_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                      os.walk(os.path.join(root, "at10k_0.orbax")) for f in fs)
    emit("checkpoint", n_history=N_HISTORY, trials=[n1, n2], launches=launches,
         resumed_equal_to_uninterrupted=sum(same), compared=len(same), steps_retained=steps,
         fallback_step=steps[-2], fallback_trials=len(fallback.trials), fell_back=fell_back,
         save_ms_per_step=save_ms, save_ms_median=float(np.median(save_ms)),
         step_bytes_at_end=step_bytes, at_10k={
             "orbax_save_ms": orbax_ms, "orbax_step_bytes": at10k_bytes,
             "pickle_save_ms": pickle_ms,
             "pickle_bytes": os.path.getsize(os.path.join(root, "at10k_0.pkl"))},
         seconds=time.perf_counter() - t_phase)
    shutil.rmtree(root, ignore_errors=True)
    assert len(resumed.trials) == N_HISTORY + n2 and len(same) == n2 and all(same), same
    assert launches["pair_score_batched"] >= 2 * n2, launches
    assert len(steps) == 3 and fell_back and len(fallback.trials) == N_HISTORY + n2 - 1
    return launches


SAMPLE_N = 65_536


def phase_device_sample_batch(T):
    """bench.py's 5-label space drawn at n = 65,536 by
    ``device_sample_batch`` under the sync debug mode "error" (any readback
    or synchronizing copy raises): tensors on the card; per label a KS test
    against ``sample_batch``'s read-back draw at another seed; ms per draw
    (CUDA events; host clock to a synchronize) beside ``sample_batch``'s."""
    from scipy import stats

    from hyperopt_tpu_torch.vectorize import CompiledSpace

    t_phase = time.perf_counter()
    cs = CompiledSpace(bench_space(T.hp))
    cs.device_sample_batch(0, SAMPLE_N)  # the generator's and allocator's first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, active = cs.device_sample_batch(1, SAMPLE_N)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_card = all(v.is_cuda for v in vals.values()) and all(a.is_cuda for a in active.values())
    ref, _ = cs.sample_batch(2, SAMPLE_N)
    ks = {lb: float(stats.ks_2samp(vals[lb].cpu().numpy(), ref[lb]).pvalue) for lb in vals}
    draw_event_ms = cuda_ms(lambda: cs.device_sample_batch(1, SAMPLE_N), 20)

    def host_ms(fn, n=20):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    emit("device_sample_batch", n=SAMPLE_N, labels=sorted(vals), on_card=on_card,
         dtypes={lb: str(v.dtype) for lb, v in vals.items()}, ks_pvalue=ks,
         draw_event_ms=draw_event_ms,
         draw_host_ms=host_ms(lambda: cs.device_sample_batch(1, SAMPLE_N)),
         sample_batch_host_ms=host_ms(lambda: cs.sample_batch(1, SAMPLE_N)),
         seconds=time.perf_counter() - t_phase)
    assert on_card and all(v.shape == (SAMPLE_N,) for v in vals.values())
    assert all(p > 1e-4 for p in ks.values()), ks


QUALITY_CANDS = 65_536


def phase_quality(T, counters):
    """``scripts/quality_study_torch.py`` at c = 65,536 on the card: the
    four domains, seeds 0-3, 60 trials each; each mean regret beside the
    reference's ``QUALITY.json`` per-seed range with its verdict (held in
    tier-1 at c = 24; a miss is recorded, not failed here), the wall
    seconds, and the pair-score launches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("quality_study_torch", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", "quality_study_torch.py"))
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rows = qs.study(cands=(QUALITY_CANDS,), device="cuda",
                    emit=lambda row: emit("quality", **row))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    emit("quality_summary", rows=len(rows), outside_reference_worst=[r["key"] for r in rows
                                                                     if not r["ok"]],
         launches=launches, seconds=time.perf_counter() - t0)
    assert len(rows) == len(qs.DOMAINS) and all(
        len(r["per_seed"]) == len(qs.SEEDS) and all(math.isfinite(x) for x in r["per_seed"])
        for r in rows)
    assert launches["pair_score_batched"] > 0, launches
    return launches


# one shard of scripts/atpe_corpus_sweep_torch.sh at its per-shard flags; the
# one cut: seeds 0-1 where the sweep runs 13
TRAIN_DOMAIN = "many_dists"
TRAIN_SEEDS = (0, 1)
TRAIN_SWEEP_SEEDS = 13
TRAIN_CONFIGS, TRAIN_CONT_EVALS, TRAIN_CHECKPOINTS = 20, 8, (20, 28, 36, 45)


def corpus_build(ta, seeds, device, shard):
    """``python -m hyperopt_tpu_torch.models.train_atpe`` for one shard of
    ``TRAIN_DOMAIN`` on ``device`` (``main`` with the sweep's flags and
    ``--rows-out``), recording the rows ``build_corpus`` returned and
    timing the TPE suggests that reach the device program
    (``tpe._suggest_device``, which returns after its readback; a
    relaunched speculation counts again).  Returns the rows and the
    build's counts: states, trials and TPE suggests (from the flags: the
    first 20 trials of each base run are random), dispatches, wall
    seconds, seconds per state, wall ms per TPE trial (the whole build:
    random trials, objectives, features and the shard's save included),
    and host ms inside the suggests, their sum and the median of one."""
    from hyperopt_tpu_torch.algos import tpe as ttpe

    suggest_ms, built = [], []
    real_dispatch, real_build = ttpe._suggest_device, ta.build_corpus

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real_dispatch(*args, **kw)
        suggest_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recorded(*args, **kw):
        built.append(real_build(*args, **kw))
        return built[-1]

    ttpe._suggest_device, ta.build_corpus = timed, recorded
    try:
        t0 = time.perf_counter()
        rc = ta.main(["--device", device, "--domains", TRAIN_DOMAIN, "--seeds", str(len(seeds)),
                      "--seed-offset", str(seeds[0]), "--configs", str(TRAIN_CONFIGS),
                      "--cont-evals", str(TRAIN_CONT_EVALS), "--checkpoints",
                      *map(str, TRAIN_CHECKPOINTS), "--rows-out", shard])
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ttpe._suggest_device, ta.build_corpus = real_dispatch, real_build
    assert rc == 0 and len(built) == 1, rc
    rows = built[0]
    trials = len(seeds) * (max(TRAIN_CHECKPOINTS)
                           + len(TRAIN_CHECKPOINTS) * TRAIN_CONFIGS * TRAIN_CONT_EVALS)
    suggests = trials - 20 * len(seeds)
    return rows, {"states": len(rows), "trials": trials, "suggests": suggests,
                  "tpe_dispatches": len(suggest_ms), "seconds": seconds,
                  "seconds_per_state": seconds / len(rows),
                  "wall_ms_per_tpe_trial": seconds * 1e3 / suggests,
                  "in_suggest_ms_total": sum(suggest_ms),
                  "in_suggest_ms_median": float(np.median(suggest_ms))}


@contextlib.contextmanager
def keeping_kernel_inputs():
    """Inside the block, ``tpe_device``'s pair-score kernel entry keeps
    copies of the first and the last ``(z, params, k_below)`` it is given
    at each distinct shape, in the dict it yields; the wrapper launches
    nothing of its own."""
    from hyperopt_tpu_torch.algos import tpe_device as td

    real, kept = td.pair_score_batched, {}

    def keeping(z, params, k_below):
        key = (*z.shape, params.shape[-1], int(k_below))
        case = (z.clone(), params.clone(), int(k_below))
        kept.setdefault(key, [case, case])[1] = case
        return real(z, params, k_below)

    td.pair_score_batched = keeping
    try:
        yield kept
    finally:
        td.pair_score_batched = real


def train_kernel_vs_plain(kept):
    """Kernel #1 against its plain version on the inputs the corpus build
    gave it (first and last of each shape), under ``TOLERANCE``."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched
    from hyperopt_tpu_torch.ops.score import pair_score

    worst, shapes = 0.0, []
    for (L, C, K, kb), cases in sorted(kept.items()):
        for which, (z, params, k_below) in zip(("first", "last"), cases):
            got = pair_score_batched(z, params, k_below)
            ref = pair_score(z, params, k_below)
            ref64 = pair_score(z.double(), params.double(), k_below)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and bool(torch.isfinite(got).all()), (L, C, K, kb)
            err = (got - ref).abs()
            allow, plain_f32_err = allowance(ref, ref64)
            row = {"L": L, "C": C, "kb": kb, "ka": K - kb, "case": which,
                   "max_abs_err": float(err.max()), "plain_vs_f64_err": plain_f32_err,
                   "ok": bool((err <= allow).all())}
            emit("train_atpe_kernel_vs_plain", **row, tolerance=TOLERANCE)
            assert row["ok"], row
            worst = max(worst, row["max_abs_err"])
        shapes.append([L, C, kb, K - kb])
    return worst, shapes


def trainer_suggest_split(T, ta, n=10, n_profiled=4):
    """One TPE suggest of the corpus build alone, outside ``fmin``: the
    shard's domain at seed 0's last checkpoint (45 trials), at each of the
    grid's candidate counts; median host ms to the docs on the card and on
    the CPU, and the card's CUDA kernels and device ms per suggest
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch.models import domains as zoo

    d = zoo.get(TRAIN_DOMAIN)
    docs = ta._run_base(d, 0, max(TRAIN_CHECKPOINTS), device="cuda").trials
    out = {}
    for c in ta.GRID["n_EI_candidates"]:
        calls = {}
        for dev in ("cuda", "cpu"):
            trials, dom = T.trials_from_docs(copy.deepcopy(docs)), T.Domain(d.fn, d.space)
            calls[dev] = partial(T.tpe.suggest, [len(docs)], dom, trials, n_EI_candidates=c,
                                 device=dev)
            calls[dev](seed=0)  # the history's first upload
            ms = []
            for i in range(n):
                t0 = time.perf_counter()
                calls[dev](seed=1 + i)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"{dev}_c{c}_ms"] = float(np.median(ms))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n_profiled):
                calls["cuda"](seed=1 + i)
            torch.cuda.synchronize()
        dev_events = [a for a in prof.key_averages() if str(a.device_type).endswith("CUDA")]
        out[f"cuda_c{c}_kernels"] = sum(a.count for a in dev_events) / n_profiled
        out[f"cuda_c{c}_device_ms"] = sum(
            getattr(a, "self_device_time_total", 0.0) for a in dev_events) / 1e3 / n_profiled
    return out


def check_corpus_rows(ta, rows):
    """Every feature finite, every label inside the grid's span, no torch
    object anywhere in a row."""
    from hyperopt_tpu_torch.algos.atpe import FEATURE_NAMES

    g = ta.GRID
    modes = dict(g["result_filtering"])
    for feats, labels in rows:
        assert all(math.isfinite(feats[k]) for k in FEATURE_NAMES), feats
        for key in ("gamma", "prior_weight", "secondary_cutoff"):
            assert min(g[key]) <= labels[key] <= max(g[key]), (key, labels[key])
        assert math.log2(min(g["n_EI_candidates"])) <= labels["n_EI_candidates"] \
            <= math.log2(max(g["n_EI_candidates"])), labels["n_EI_candidates"]
        assert labels["result_filtering_mode"] in modes, labels["result_filtering_mode"]
        assert min(modes.values()) <= labels["result_filtering_multiplier"] <= 1.0
    assert ta._tensor_path(rows) is None, ta._tensor_path(rows)


def phase_train_atpe(T, counters):
    """``models.train_atpe``'s corpus build on the card: one shard of
    ``many_dists`` at the sweep's per-shard flags (20 configs, 8
    continuation evals, checkpoints 20 28 36 45), seeds 0-1 (the sweep runs
    13): 8 rows, features finite, labels in the grid, no tensor, the shard
    through ``save_rows``/``load_rows``, the pair-score kernel launched and
    held against its plain version on the first and last inputs of each
    shape the build gave it, the shipped artifacts untouched.  Then seed 0
    alone with ``device="cpu"`` on this machine: seconds per state, wall ms
    per TPE trial and the median host ms of one suggest each way (the card
    builds first, so its program builds fall in its sum, not in the
    median), and one suggest alone on each (``trainer_suggest_split``).  Where
    sklearn is absent, a fitting run fails naming it before any row is
    built."""
    import hashlib

    from hyperopt_tpu_torch.algos.atpe import DEFAULT_MODEL_DIR
    from hyperopt_tpu_torch.models import train_atpe as ta

    def digests():
        return {f: hashlib.sha256(open(os.path.join(DEFAULT_MODEL_DIR, f), "rb").read())
                .hexdigest() for f in sorted(os.listdir(DEFAULT_MODEL_DIR))}

    t_phase = time.perf_counter()
    shipped = digests()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_atpe_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        import sklearn

        sklearn_version = sklearn.__version__
    except ImportError:
        sklearn_version = None

    for c in counters:
        c.launches = 0
    shard = os.path.join(work, f"{TRAIN_DOMAIN}.s0_{len(TRAIN_SEEDS)}.pkl")
    with keeping_kernel_inputs() as kept:
        rows, card = corpus_build(ta, TRAIN_SEEDS, "cuda", shard)
    launches = {c.__name__: c.launches for c in counters}
    check_corpus_rows(ta, rows)
    kernel_err, kernel_shapes = train_kernel_vs_plain(kept)
    round_trip = ta.load_rows([shard]) == rows

    cpu_rows, cpu = corpus_build(ta, TRAIN_SEEDS[:1], "cpu",
                                 os.path.join(work, f"{TRAIN_DOMAIN}.cpu.pkl"))
    check_corpus_rows(ta, cpu_rows)
    split = trainer_suggest_split(T, ta)

    # where sklearn does not import, a fitting run fails naming it before
    # any row is built (build_corpus is stubbed to count calls)
    fit = {}
    out = os.path.join(work, "artifacts")
    if sklearn_version is None:
        real_build, builds = ta.build_corpus, []
        ta.build_corpus = lambda *a, **k: builds.append(a) or []
        try:
            ta.main(["--device", "cuda", "--domains", TRAIN_DOMAIN, "--seeds", "1",
                     "--configs", "2", "--cont-evals", "2", "--checkpoints", "20",
                     "--out", out])
            fit["error"] = None
        except RuntimeError as e:
            fit["error"] = str(e)
        finally:
            ta.build_corpus = real_build
        fit["builds_before_the_error"] = len(builds)
    emit("train_atpe", domain=TRAIN_DOMAIN, seeds=list(TRAIN_SEEDS), configs=TRAIN_CONFIGS,
         cont_evals=TRAIN_CONT_EVALS, checkpoints=list(TRAIN_CHECKPOINTS),
         cut=f"seeds {TRAIN_SEEDS[0]}-{TRAIN_SEEDS[-1]} of the sweep's {TRAIN_SWEEP_SEEDS}",
         card=card, cpu_seed0=cpu,
         card_over_cpu_wall_ms_per_tpe_trial=card["wall_ms_per_tpe_trial"]
         / cpu["wall_ms_per_tpe_trial"],
         card_over_cpu_in_suggest_median=card["in_suggest_ms_median"]
         / cpu["in_suggest_ms_median"], suggest_alone=split, launches=launches,
         launches_per_suggest=launches["pair_score_batched"] / card["suggests"],
         kernel_shapes_L_C_kb_ka=kernel_shapes, kernel_max_abs_err=kernel_err,
         tolerance=TOLERANCE,
         round_trip=round_trip, sklearn=sklearn_version is not None,
         sklearn_version=sklearn_version, fit=fit,
         shipped_artifacts_unchanged=digests() == shipped,
         seconds=time.perf_counter() - t_phase)
    assert len(rows) == len(TRAIN_SEEDS) * len(TRAIN_CHECKPOINTS), card
    assert len(cpu_rows) == len(TRAIN_CHECKPOINTS)
    assert card["tpe_dispatches"] >= card["suggests"] and cpu["tpe_dispatches"] >= cpu["suggests"]
    assert round_trip and digests() == shipped
    assert launches["pair_score_batched"] > 0, launches
    if sklearn_version is None:
        assert fit["error"] and "sklearn" in fit["error"] and not fit["builds_before_the_error"]
        assert not os.path.exists(out)
    shutil.rmtree(work, ignore_errors=True)
    return launches


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
    # the partials launch at the shard shape of the 2x2 mesh's main path:
    # C/dp candidates against ceil(Kb/sp) + ceil(Ka/sp) components
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials
    from hyperopt_tpu_torch.ops.score import pair_lse_partials as plain_partials
    from hyperopt_tpu_torch.parallel.sharding import _region_shards

    s = MAIN_SHAPE
    z, params = pair_case(seed=6, **s)
    zs = z[:, :s["C"] // 2].contiguous()
    shards, wb = _region_shards(params, s["kb"], 2)
    ps = shards[0]
    L, C, K = zs.shape[0], zs.shape[1], ps.shape[2]

    def library_partials():
        feats = torch.stack([zs * zs, zs, torch.ones_like(zs)], dim=-1)
        comp = torch.matmul(feats, ps)
        return torch.stack([torch.logsumexp(comp[..., :wb], -1),
                            torch.logsumexp(comp[..., wb:], -1)])

    rows.append(row(
        "pair_lse_partials", lambda: pair_lse_partials(zs, ps, wb), ["pair_score_kernel"],
        L * C * K, 4 * (3 * L * C + 3 * L * K),
        source="hyperopt_tpu_torch/csrc/pair_score.cu (partials launch)",
        replaces="hyperopt_tpu/ops/pallas_gmm.py:127",
        launches=launches["pair_lse_partials"], max_abs_err=errs["pair_lse_partials"],
        shard_shape={"L": L, "C": C, "K": K, "kb": wb},
        ms_full_shape=cuda_ms(lambda: pair_lse_partials(z, params, s["kb"]), iters=200),
        plain_ms=cuda_ms(lambda: plain_partials(zs, ps, wb), 10),
        library_ms=cuda_ms(library_partials, 10)))
    for r in rows:
        emit("timing", kernel=r["name"], **{k: r[k] for k in (
            "ms", "device_ms", "device_ms_by_kernel", "ms_draw", "device_ms_draw", "plain_ms",
            "ms_full_shape", "shard_shape",
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
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the plain versions and the library yardstick run IEEE f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("HYPEROPT_TPU_SCORER", "HYPEROPT_TPU_FUSED_DRAW", "HYPEROPT_MAX_SPECULATION"):
        os.environ.pop(k, None)  # the default tier unless a phase sets one
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest
    from hyperopt_tpu_torch.ops.pair_kernel import (pair_lse_partials, pair_score_batched,
                                                    pair_score_single)

    assert "jax" not in sys.modules and not any(
        m == "hyperopt_tpu" or m.startswith("hyperopt_tpu.") for m in sys.modules)
    counters = [pair_score_batched, fused_suggest, pair_score_single, pair_lse_partials]
    smi, card = phase_card()
    phase_build()
    errs = {"pair_score_batched": phase_kernel_vs_plain(),
            "fused_suggest": phase_fused_vs_plain(),
            "pair_score_single": single_label_err()}
    phase_suggest_vs_cpu(T)
    launches, trials, steady_ms, stats = phase_main_path(T, counters)
    process_state("after_main_path")
    fused_runs = phase_fused_main_path(T, counters, trials)
    phase_search_health(stats, fused_runs)
    phase_profile(T, trials, steady_ms, "pallas")
    with scorer_env(HYPEROPT_TPU_SCORER="fused"):
        phase_profile(T, fused_runs["0"][1], fused_runs["0"][2], "fused")
    single = phase_single_label(counters)
    phase_quickstart(T, counters)
    pipelined = phase_pipelined_main_path(T, counters)
    phase_multi_study(T, counters)
    phase_multi_id_suggest(T, counters, card)
    phase_atpe_path(T, counters)
    phase_anneal_mix(T, counters)
    parallel_ms = phase_parallel_backend(T, counters, pipelined)
    phase_file_trials(T, counters, pipelined, parallel_ms)
    phase_space_lint(T, counters)
    phase_device_recovery(T, counters)
    phase_profiler(T, counters, trials)
    service_launches = phase_service(T, counters)
    replica_launches = phase_replica_failover(T)
    errs["pair_lse_partials"], mesh_launches = phase_mesh(T, counters)
    phase_self_lint()
    audit_launches = phase_recompile_audit(T, counters)
    checkpoint_launches = phase_checkpoint(T, counters)
    phase_device_sample_batch(T)
    quality_launches = phase_quality(T, counters)
    train_launches = phase_train_atpe(T, counters)
    launches = {**launches, "fused_suggest": fused_runs["0"][0]["fused_suggest"],
                "pair_lse_partials": mesh_launches,
                "fused_suggest_draw": fused_runs["1"][0]["fused_suggest"],
                "pair_score_single": single["pair_score_single"]}
    kernels = phase_timing(errs, launches, card)
    for r in kernels:
        # the launches of the service phase's concurrent run, its own path
        r["launches_service"] = service_launches[r["name"]]
        # the surviving replica's launches after the kill (its own process)
        r["launches_replica_failover"] = replica_launches[r["name"]]
        # the launches of this slice's paths: the recompile audit, the
        # checkpointed fmin and the regret check
        r["launches_recompile_audit"] = audit_launches[r["name"]]
        r["launches_checkpoint"] = checkpoint_launches[r["name"]]
        r["launches_quality"] = quality_launches[r["name"]]
        # the card's corpus build of the ATPE trainer's shard
        r["launches_train_atpe"] = train_launches[r["name"]]
    assert "jax" not in sys.modules and not any(
        m == "hyperopt_tpu" or m.startswith("hyperopt_tpu.") for m in sys.modules)
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
