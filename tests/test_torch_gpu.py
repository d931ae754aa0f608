"""Card-only checks of the port's CUDA kernel (marker ``gpu``).

Run on a machine with a CUDA card: ``pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``--noconftest``: ``tests/conftest.py`` sets JAX up, and the port needs no JAX).
Without a card every test here skips; whether a card is present is decided
inside the ``cuda`` fixture, never at import.
"""

import json

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched
from hyperopt_tpu_torch.ops.score import pair_params, pair_score

pytestmark = pytest.mark.gpu


def assert_close_to_plain(got, ref, ref64):
    """Per score: atol 1e-4 + rtol 1e-5 for the summation order of a long
    logsumexp, plus twice the plain f32 version's own largest error against
    its f64 evaluation (the quadratic form cancels terms of ~1e5 at narrow
    sigmas, so two f32 evaluations differ by ~1e-3 there)."""
    plain_err = float((ref.double() - ref64).abs().max())
    allow = 1e-4 + 1e-5 * ref.abs() + 2 * plain_err
    assert bool(((got - ref).abs() <= allow).all()), float((got - ref).abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest --noconftest -m gpu tests/test_torch_gpu.py` on one")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's IEEE f32 matmul
    return torch.device("cuda")


def case(L, C, kb, ka, seed, real_a=None):
    g = torch.Generator().manual_seed(seed)

    def mixture(k, real):
        w = torch.rand(L, k, generator=g) + 0.05
        w[:, real:] = 0.0
        w = w / w.sum(dim=1, keepdim=True)
        return w, torch.randn(L, k, generator=g) * 2.0, torch.rand(L, k, generator=g) + 0.01

    params = pair_params(*mixture(kb, kb), *mixture(ka, ka if real_a is None else real_a))
    z = torch.rand(L, C, generator=g) * 10.0 - 5.0
    return z, params.contiguous()


@pytest.mark.parametrize("shape", [
    dict(L=2, C=8192, kb=33, ka=16385, real_a=10001),  # the main path at 10k history
    dict(L=2, C=70, kb=1, ka=40),
    dict(L=3, C=1000, kb=17, ka=1025, real_a=900),
])
def test_kernel_matches_plain_on_card(cuda, shape):
    z, params = case(seed=0, **shape)
    z, params = z.to(cuda), params.to(cuda)
    before = pair_score_batched.launches
    got = pair_score_batched(z, params, shape["kb"])
    torch.cuda.synchronize()
    assert pair_score_batched.launches == before + 1
    ref = pair_score(z, params, shape["kb"])
    ref64 = pair_score(z.double(), params.double(), shape["kb"])
    assert torch.isfinite(got).all()
    assert_close_to_plain(got, ref, ref64)
    # and against the CPU's plain version of the same inputs
    cpu = pair_score(z.cpu(), params.cpu(), shape["kb"])
    assert_close_to_plain(got.cpu(), cpu, ref64.cpu())


def test_suggest_runs_on_card(cuda):
    import hyperopt_tpu_torch as T

    space = {"x": T.hp.uniform("x", -5, 5), "c": T.hp.choice("c", [0, 1, 2])}
    trials = T.Trials()
    T.fmin(lambda p: (p["x"] - 1.0) ** 2 + p["c"], space,
           algo=T.partial(T.tpe.suggest, n_startup_jobs=5), max_evals=15,
           trials=trials, rstate=np.random.default_rng(0), show_progressbar=False)
    assert len(trials.trials) == 15
    assert all(-5 <= d["misc"]["vals"]["x"][0] <= 5 for d in trials.trials)


def fused_case(L, k, n_cand, kb, ka, seed, log_scale=False):
    """The fused kernel's inputs on the card: mixtures as ``case`` makes
    them, bounded to [-3, 3], uniforms from a seeded generator."""
    from hyperopt_tpu_torch.ops.gmm import draw_param_rows, gmm_sample

    g = torch.Generator().manual_seed(seed)

    def mixture(K):
        w = torch.rand(L, K, generator=g) + 0.05
        w = w / w.sum(dim=1, keepdim=True)
        return w, torch.randn(L, K, generator=g), torch.rand(L, K, generator=g) + 0.3

    B = [a.cuda() for a in mixture(kb)]
    A = [a.cuda() for a in mixture(ka)]
    lo, hi = torch.full((L,), -3.0, device="cuda"), torch.full((L,), 3.0, device="cuda")
    u = torch.rand((2, L, k * n_cand), generator=g).cuda()
    cands = gmm_sample(u[0], u[1], *B, lo, hi, torch.zeros(L, device="cuda"), log_scale)
    return (u[0].contiguous(), u[1].contiguous(), draw_param_rows(*B, lo, hi).contiguous(),
            cands.contiguous(), pair_params(*B, *A).contiguous())


@pytest.mark.parametrize("shape", [
    dict(L=2, k=1, n_cand=8192, kb=33, ka=16385),  # the main path at 10k history
    dict(L=3, k=4, n_cand=100, kb=9, ka=300, log_scale=True),
])
@pytest.mark.parametrize("draw", [False, True])
def test_fused_kernel_on_card(cuda, shape, draw):
    """The fused kernel's winners equal the pair-score kernel + argmax on
    its candidates bit for bit; its EI partials agree with its plain
    version within the pair-score tolerance; its in-kernel draw equals
    gmm_sample's to 2 ulp."""
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest, fused_suggest_plain

    L, k, n, kb = shape["L"], shape["k"], shape["n_cand"], shape["kb"]
    ls = shape.get("log_scale", False)
    u1, u2, rows, cands, params = fused_case(seed=1, **shape)
    args = (u1, u2, rows) if draw else (cands, None, None)
    before = fused_suggest.launches
    win, idx, seg_m, seg_s, seg_top = fused_suggest(*args, params, kb, k, log_scale=ls,
                                                    draw_in_kernel=draw)
    x = cands
    if draw:  # every drawn candidate: k * n segments of one candidate each
        x = fused_suggest(u1, u2, rows, params, kb, k * n, n_top=1, log_scale=ls,
                          draw_in_kernel=True)[0]
        ulp = (x.view(torch.int32).long() - cands.view(torch.int32).long()).abs()
        assert int(ulp.max()) <= 2 and float((ulp == 0).double().mean()) >= 0.99
    torch.cuda.synchronize()
    assert fused_suggest.launches == before + 1 + draw
    z = torch.log(x.clamp(min=1e-12)) if ls else x
    s = pair_score_batched(z.contiguous(), params, kb).reshape(L, k, n)
    ref_idx = torch.argmax(s, dim=2)
    ref_win = x.reshape(L, k, n).gather(2, ref_idx[:, :, None])[:, :, 0]
    assert torch.equal(idx.long(), ref_idx)
    assert torch.equal(win.view(torch.int32), ref_win.view(torch.int32))
    plain = fused_suggest_plain(*args, params, kb, k, log_scale=ls, draw_in_kernel=draw)
    ref = pair_score(z, params, kb)
    plain_err = float((ref.double() - pair_score(z.double(), params.double(), kb)).abs().max())
    allow = 1e-4 + 1e-5 * float(ref.abs().max()) + 2 * plain_err
    assert float((seg_m - plain[2]).abs().max()) <= allow
    assert float((seg_top - plain[4]).abs().max()) <= allow
    assert float((seg_s.log() - plain[3].log()).abs().max()) <= 2 * allow


def test_pair_score_single_on_card(cuda):
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_single

    z, params = case(L=1, C=8192, kb=33, ka=16385, seed=2, real_a=10001)
    z, params = z.to(cuda), params.to(cuda)
    before = (pair_score_single.launches, pair_score_batched.launches)
    got = pair_score_single(z[0].contiguous(), params[0].contiguous(), 33)
    torch.cuda.synchronize()
    assert (pair_score_single.launches, pair_score_batched.launches) == (before[0] + 1,
                                                                         before[1])
    assert_close_to_plain(got[None], pair_score(z, params, 33),
                          pair_score(z.double(), params.double(), 33))


def test_single_launch_equals_row0_of_batched_bitwise(cuda):
    """The L=1 launch (4 candidates per warp) and row 0 of an L=2 launch (8
    per warp) give the same bits: a score depends only on K and the lane's
    components, not on the launch (csrc/pair_lse.cuh)."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_single

    z, params = case(L=2, C=8192, kb=33, ka=16385, seed=3, real_a=10001)
    z, params = z.to(cuda), params.to(cuda)
    both = pair_score_batched(z, params, 33)
    one = pair_score_single(z[0].contiguous(), params[0].contiguous(), 33)
    torch.cuda.synchronize()
    assert torch.equal(one.view(torch.int32), both[0].view(torch.int32))


@pytest.mark.parametrize("shape", [
    dict(L=2, C=8192, kb=33, ka=16385, real_a=10001),
    dict(L=3, C=1000, kb=1, ka=1025, real_a=900),
])
def test_candidates_per_warp_choices_bitwise(cuda, shape):
    """The kernel's two candidates-per-warp instances give the same bits."""
    import ctypes

    from hyperopt_tpu_torch.ops import kernel_build

    fn = kernel_build.load("pair_score").pair_score_batched_launch_cpw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    z, params = case(seed=4, **shape)
    z, params = z.to(cuda), params.to(cuda)
    L, C = z.shape
    outs = []
    for cpw in (4, 8):
        out = torch.empty_like(z)
        err = fn(z.data_ptr(), params.data_ptr(), out.data_ptr(), L, C, params.shape[2],
                 shape["kb"], cpw, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert torch.isfinite(outs[0]).all()


def test_fused_top128_merges_from_global_memory(cuda):
    """n_top = 128 at L=1, 8192 candidates: the merge kernel ranks the
    largest top set from the tiles' partials in device memory (67 KB); its
    top set, winner and (m, s) agree with the plain version."""
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest, fused_suggest_plain

    _, _, _, cands, params = fused_case(L=1, k=1, n_cand=8192, kb=33, ka=16385, seed=5)
    got = fused_suggest(cands, None, None, params, 33, 1, n_top=128)
    plain = fused_suggest_plain(cands, None, None, params, 33, 1, n_top=128)
    torch.cuda.synchronize()
    s = pair_score_batched(cands, params, 33)
    assert torch.equal(got[1].long(), torch.argmax(s, dim=1, keepdim=True))
    ref = pair_score(cands, params, 33)
    plain_err = float((ref.double() - pair_score(cands.double(), params.double(), 33)).abs().max())
    allow = 1e-4 + 1e-5 * float(ref.abs().max()) + 2 * plain_err
    assert float((got[4] - plain[4]).abs().max()) <= allow
    assert float((got[2] - plain[2]).abs().max()) <= allow
    assert float((got[3].log() - plain[3].log()).abs().max()) <= 2 * allow


def card_history(n, seed=0):
    """``(domain, trials)``: ``n`` completed trials over a 3-label space,
    values and losses from a seeded numpy generator."""
    import hyperopt_tpu_torch as T

    space = {"x": T.hp.uniform("x", -5, 5), "lg": T.hp.loguniform("lg", -4, 1),
             "c": T.hp.choice("c", [0, 1, 2])}
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        vals = {"x": float(rng.uniform(-5, 5)), "lg": float(np.exp(rng.uniform(-4, 1))),
                "c": int(rng.integers(3))}
        docs.append({"tid": i, "spec": None,
                     "result": {"status": "ok", "loss": float(rng.standard_normal())},
                     "misc": {"tid": i, "cmd": None, "idxs": {k: [i] for k in vals},
                              "vals": {k: [v] for k, v in vals.items()}},
                     "state": 2, "owner": None, "book_time": None, "refresh_time": None,
                     "exp_key": None})
    trials = T.Trials()
    trials._insert_trial_docs(docs)
    trials.refresh()
    return T.Domain(lambda c: 0.0, space), trials, docs


def test_suggest_async_on_card_equals_suggest(cuda):
    import hyperopt_tpu_torch as T

    domain, trials, _ = card_history(3000)
    kw = dict(n_EI_candidates=4096)
    for ids in ([3000], [3000, 3001]):
        eager = T.tpe.suggest(ids, domain, trials, 17, **kw)
        resolve = T.tpe.suggest_async(ids, domain, trials, 17, **kw)
        assert [d["misc"]["vals"] for d in resolve()] == [d["misc"]["vals"] for d in eager]


def test_in_flight_suggest_reads_the_history_it_was_launched_on(cuda):
    """Stream order: a suggest launched, then one more completed trial
    synced into the same device history (appended in place), then the
    suggest resolved, gives the suggest of the history before the append."""
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.algos import tpe_device as td

    n, kw = 10_000, dict(n_EI_candidates=8192)
    domain, trials, docs = card_history(n)
    T.tpe.suggest([n], domain, trials, 3, **kw)  # first sync: the full upload
    resolve = T.tpe.suggest_async([n + 1], domain, trials, 23, **kw)
    best = dict(docs[0], tid=n, result={"status": "ok", "loss": -1e6},
                misc=dict(docs[0]["misc"], tid=n,
                          idxs={k: [n] for k in docs[0]["misc"]["idxs"]}))
    trials._insert_trial_docs([best])
    trials.refresh()
    dh = td.device_history_for(trials, domain.space, "cuda")
    dh.sync(trials.history)  # in place, on the suggest stream
    got = [d["misc"]["vals"] for d in resolve()]
    assert dh.full_rebuilds == 1
    _, before, _ = card_history(n)
    ref = T.tpe.suggest([n + 1], domain, before, 23, **kw)
    assert got == [d["misc"]["vals"] for d in ref]


def test_eight_id_suggest_on_card_agrees_with_cpu(cuda, monkeypatch):
    """An 8-id suggest (one pair-score launch per unquantized family, over
    8 × 4096 candidates per label, not one per id) over bench.py's space at
    a 3000-trial history, on the card and on the CPU from one set of
    uniform streams, held to ``chip_smoke``'s rule for k-id suggests: at
    least ``AGREEMENT_SHARE`` of the (id, label) values equal to rtol 1e-5,
    each other one a near-tie within twice the kernel's TOLERANCE under
    the CPU's own scorer."""
    import chip_smoke as cs
    import hyperopt_tpu_torch as T

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # the pair-score kernel
    trials = cs.prefilled_trials(T, 3000)
    domain = T.Domain(cs.bench_objective, cs.bench_space(T.hp))
    ids = list(range(3000, 3008))
    kw = dict(n_EI_candidates=4096)
    seeds = range(3)
    before = pair_score_batched.launches
    pairs, close, mismatches = cs.card_agrees_with_cpu(T, domain, trials, ids, seeds, **kw)
    assert pair_score_batched.launches == before + 2 * len(seeds)  # lr+sigma; momentum+z
    cs.assert_agreement(pairs, close, cs.near_ties(T, domain, trials, ids, mismatches, **kw))


def test_torch_trials_device_plane_on_card(cuda):
    """TorchTrials' device plane on the card: every claimed batch is one
    vmapped call (no host thread), each loss equal to the host objective to
    rel 1e-4 (f32 on the card, TF32 off)."""
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.models import domains

    def branin_torch(c):
        x, y = c["x"], c["y"]
        a, b, cc = 1.0, 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
        return a * (y - b * x ** 2 + cc * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s

    d = domains.get("branin")
    trials = T.TorchTrials(parallelism=8, device_fn=branin_torch)
    T.fmin(d.fn, d.space, algo=T.tpe.suggest, max_evals=40, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, return_argmin=False)
    assert len(trials) == 40 and trials.device_batches > 0 and trials.host_trials == 0
    for t in trials.trials:
        assert t["state"] == T.JOB_STATE_DONE
        cfg = {k: v[0] for k, v in t["misc"]["vals"].items()}
        assert t["result"]["loss"] == pytest.approx(d.fn(cfg), rel=1e-4)


def test_file_trials_with_threaded_workers_on_card(cuda, monkeypatch, tmp_path):
    """``FileTrials`` with two threaded workers and ``tpe.suggest`` on the
    card at a 2000-trial history with 4096 candidates: 2 pair-score
    launches per suggest call, every trial DONE, each call's suggestion
    equal bit for bit to the card's suggest from a fresh ``Trials``
    holding the same docs, and the card's values against the CPU's (same
    history, same uniform streams) by ``chip_smoke``'s rule for k-id
    suggests, over the call's seed and 7 more per call (a share read over
    ~1,000 values, not ~80)."""
    import copy
    import threading

    import chip_smoke as cs
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.parallel.worker import FileWorker, ReserveTimeout

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # the pair-score kernel
    qdir = str(tmp_path / "q")
    trials = T.FileTrials(qdir)
    assert trials.new_trial_ids(2000) == list(range(2000))
    cs.prefilled_trials(T, 2000, trials=trials)
    kw = dict(n_EI_candidates=4096)
    calls, tally = [], {"pairs": 0, "close": 0, "ties": [], "split": []}

    def card_and_cpu(new_ids, domain, trials_, seed):
        # a plain function: the engine stays off and the loop is serial
        before, cards = pair_score_batched.launches, []
        with cs.cpu_drawn_streams():
            fresh = T.tpe.suggest(new_ids, domain, T.trials_from_docs(
                copy.deepcopy(trials_._dynamic_trials)), seed, **kw)
        seeds = [seed] + [seed + i for i in range(1, 8)]
        pairs, close, mismatches = cs.card_agrees_with_cpu(
            T, domain, trials_, new_ids, seeds, cards=cards, **kw)
        calls.append((len(new_ids), pair_score_batched.launches - before))
        assert ([d["misc"]["vals"] for d in cards[0]]
                == [d["misc"]["vals"] for d in fresh])
        tally["pairs"] += pairs
        tally["close"] += close
        tally["ties"] += cs.near_ties(T, domain, trials_, new_ids, mismatches, **kw)
        tally["split"] += cs.split_mismatches(T, domain, trials_, new_ids, mismatches, **kw)
        return cards[0]

    stop = threading.Event()

    def work():
        w = FileWorker(qdir, poll_interval=0.02)
        while not stop.is_set():
            try:
                w.run_one(reserve_timeout=0.5)
            except ReserveTimeout:
                continue

    workers = [threading.Thread(target=work, daemon=True) for _ in range(2)]
    for t in workers:
        t.start()
    try:
        T.fmin(cs.bench_objective, cs.bench_space(T.hp), algo=card_and_cpu,
               max_evals=2016, trials=trials, max_queue_len=2,
               rstate=np.random.default_rng(0), show_progressbar=False)
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=30)
    trials.refresh()
    new = [d for d in trials._dynamic_trials if d["tid"] >= 2000]
    assert len(new) == 16 and all(d["state"] == T.JOB_STATE_DONE for d in new)
    # one launch per unquantized family (lr+sigma, momentum+z): the fresh
    # Trials' suggest, then 8 seeds against the CPU
    assert calls and all(launched == 2 * 9 for _, launched in calls), calls
    cs.assert_agreement(tally["pairs"], tally["close"], tally["ties"], tally["split"])


def _draw_stages(T, domain, trials, ids, seed, label, device, **kw):
    """One unquantized label's candidate draw of ``tpe.suggest`` (what
    ``tpe.plain_label_scores`` draws), stage by stage on ``device``: the
    below mixture's Parzen fit ``w``/``mu``/``sigma``, the draw's table
    (``ops.gmm.draw_param_rows``), the picked component's ``mu`` and
    ``sigma·t``, the fit-space draw ``x = mu + sigma·t`` and the raw
    value."""
    from hyperopt_tpu_torch.algos import tpe_device as td
    from hyperopt_tpu_torch.ops import gmm as gmm_ops
    from hyperopt_tpu_torch.ops import parzen as parzen_ops

    requests, _ = T.tpe.suggest_prepare(ids, domain, trials, seed, device=device, **kw)
    fams = td.device_history_for(trials, domain.space, device).families.values()
    for (kind, args, st), fam in zip(requests, fams):
        if label not in fam.labels:
            continue
        i = fam.labels.index(label)
        u, obs, pos, counts, losses, keep, n_below, pw, prior, lock_c, lock_r = args
        below, nb, _, _ = td._split_pack(obs, pos, counts, td._loss_ranks(losses, keep), keep,
                                         n_below, lock_c, lock_r, st["cap_b"],
                                         lock_fallback=False)
        pm, ps, lo, hi, _ = prior.unbind(dim=1)
        B = parzen_ops.adaptive_parzen_normal_padded(below, nb, pw, pm, ps, st["lf"])
        rows = gmm_ops.draw_param_rows(*B, lo, hi)
        # gmm_ops.draw_from_rows, keeping its intermediates
        cdf = rows[:, 0].contiguous()
        total = cdf[:, -1:]
        tt = torch.minimum(u[:, 0] * total, total * (1.0 - 1e-6))
        comp = torch.searchsorted(cdf, tt.contiguous(), right=True).clamp_(0, cdf.shape[1] - 1)
        ea, eb = rows[:, 3].gather(1, comp), rows[:, 4].gather(1, comp)
        uu = torch.maximum(ea, gmm_ops._fma(u[:, 1], eb - ea, ea))
        t = gmm_ops._SQRT2 * gmm_ops.erfinv_f32(uu)
        t = torch.minimum(torch.maximum(t, rows[:, 5].gather(1, comp)), rows[:, 6].gather(1, comp))
        mu_c, sg_c = rows[:, 1].gather(1, comp), rows[:, 2].gather(1, comp)
        x = gmm_ops._fma(sg_c, t, mu_c)
        raw = torch.exp(x) if st["log_scale"] else x
        out = {"w": B[0][i], "mu": B[1][i], "sigma": B[2][i], "rows": rows[i], "comp": comp[i],
               "log1p": -torch.log1p(-uu * uu)[i], "t": t[i],
               "mu_c": mu_c[i], "sigma_t": (sg_c * t)[i], "x": x[i], "raw": raw[i]}
        return {k: v.cpu().numpy() for k, v in out.items()}
    raise KeyError(label)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_card_draws_hold_the_draw_contract(cuda, monkeypatch):
    """At the agreement test's history (``prefilled_trials(T, 2000)``, 4096
    candidates, two ids, seeds 0–7), every unquantized label's candidate
    draw on the card against the CPU's from the same streams, stage by
    stage (``_draw_stages``), held to the port's contract for its draw
    against JAX's (``tests/test_torch_ops.py::
    test_gmm_sample_with_jax_streams``: at least 98% within 2 ulps, all
    within rtol 2e-6 and 2 ulps of the sample's scale ``max |x|``) where
    the draw is rounded: the fit-space ``x = mu + sigma·t`` (a log-scale
    label's raw value is ``exp(x)``, which turns an ulp of ``x`` into up
    to ``|x|`` ulps of the raw value).  The Parzen fit is the CPU's bit
    for bit.  The printed line carries, per stage, how many values differ
    and by how many ulps: ``log1p`` (in ``erfinv``) is where the card's
    arithmetic first departs from the CPU's; ``t`` and ``x`` follow, and
    ``max_ulps_of_scale`` reads ``x``'s gap in ulps of each candidate's
    own ``max(|mu|, |sigma·t|)``."""
    import chip_smoke as cs
    import hyperopt_tpu_torch as T

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")
    trials = cs.prefilled_trials(T, 2000)
    domain = T.Domain(cs.bench_objective, cs.bench_space(T.hp))
    ids, kw = [2000, 2001], dict(n_EI_candidates=4096)
    stats, outside = {}, []

    def tally(lb, stage, card, cpu):
        slot = stats.setdefault(lb, {}).setdefault(stage, {"values": 0, "differ": 0, "max_ulps": 0})
        d = _ulps(card, cpu)
        slot["values"] += int(d.size)
        slot["differ"] += int((d > 0).sum())
        slot["max_ulps"] = max(slot["max_ulps"], int(d.max()))
        return slot, d

    eps = float(np.finfo(np.float32).eps)
    with cs.cpu_drawn_streams():
        for seed in range(8):
            for lb in ("lr", "sigma", "momentum", "z"):
                cpu = _draw_stages(T, domain, trials, ids, seed, lb, "cpu", **kw)
                card = _draw_stages(T, domain, trials, ids, seed, lb, "cuda", **kw)
                for stage in ("w", "mu", "sigma", "rows", "log1p", "t", "raw"):
                    tally(lb, stage, card[stage], cpu[stage])
                assert (card["comp"] == cpu["comp"]).all(), (seed, lb)
                slot, d = tally(lb, "x", card["x"], cpu["x"])
                own = np.maximum(np.abs(cpu["mu_c"]), np.abs(cpu["sigma_t"]))
                gap = np.abs(card["x"].astype(np.float64) - cpu["x"])
                slot["max_ulps_of_scale"] = max(slot.get("max_ulps_of_scale", 0.0), float(
                    (gap / np.spacing(own.astype(np.float32))).max()))
                x_cpu = cpu["x"].reshape(len(ids), -1)
                allow = 2e-6 * np.abs(x_cpu) + 2 * eps * np.abs(x_cpu).max(axis=1, keepdims=True)
                if (d <= 2).mean() < 0.98 or (gap.reshape(x_cpu.shape) > allow).any():
                    outside.append((seed, lb, float((d <= 2).mean())))
    print("draw_stages", json.dumps(stats))
    assert all(stats[lb][k]["differ"] == 0 for lb in stats for k in ("w", "mu", "sigma")), stats
    assert not outside, (outside, stats)


def _pipelined_run(T, cs, observer=None, n=6):
    """The pipelined fmin (k=1) over bench.py's space at a 300-trial
    history and 1024 candidates, ``observer`` on the suggest dispatches."""
    from functools import partial

    from hyperopt_tpu_torch.algos import tpe_device

    trials = cs.prefilled_trials(T, 300)
    it = T.FMinIter(partial(T.tpe.suggest, n_EI_candidates=1024),
                    T.Domain(cs.bench_objective, cs.bench_space(T.hp)), trials,
                    rstate=np.random.default_rng(0), max_evals=300 + n,
                    show_progressbar=False, max_speculation=1)
    if observer is not None:
        tpe_device._suggest_observers.append(observer)
    try:
        it.exhaust()
    finally:
        if observer is not None:
            tpe_device._suggest_observers.remove(observer)
    return it, [d["misc"]["vals"] for d in trials.trials[300:]]


def test_device_recovery_with_a_real_oom_on_card(cuda, monkeypatch):
    """A genuine ``torch.cuda.OutOfMemoryError`` (an allocation past the
    card's memory) inside the first suggest dispatch: the recovery
    re-initializes once, the run goes on and its trials equal a fault-free
    run's."""
    import chip_smoke as cs
    import hyperopt_tpu_torch as T

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # the pair-score kernel
    _, ref = _pipelined_run(T, cs)
    seen = []

    def oom_once(requests):
        seen.append(requests[0][1][1].device)
        if len(seen) == 1:
            # past the card's whole memory: no cached block a retry frees
            # can make room for it
            _, total = torch.cuda.mem_get_info()
            torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")

    it, vals = _pipelined_run(T, cs, oom_once)
    assert vals == ref
    assert it.fault_stats.counts() == {"device_error": 1, "device_reinit": 1}
    assert it.fault_stats.get("cpu_fallback") == 0
    assert all(d.type == "cuda" for d in seen)


def test_profiler_device_seconds_from_cuda_events_on_card(cuda, monkeypatch):
    """On the card the profiler's ``device_s`` is the span of two CUDA
    events on the suggest stream around the dispatch's launches: positive,
    and no longer than the host-observed launch-to-readback time."""
    import chip_smoke as cs
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch import profiling
    from hyperopt_tpu_torch.algos import tpe_device
    from hyperopt_tpu_torch.observability import DeviceStats

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")
    trials = cs.prefilled_trials(T, 300)
    domain = T.Domain(cs.bench_objective, cs.bench_space(T.hp))
    events = []

    def also_events(requests):
        return events.append

    stats = DeviceStats()
    T.tpe.suggest([300], domain, trials, 0, n_EI_candidates=1024)  # history upload
    with profiling.DeviceProfiler(stats=stats):
        tpe_device._suggest_observers.append(also_events)
        try:
            for i in range(3):
                T.tpe.suggest([301 + i], domain, trials, 1 + i, n_EI_candidates=1024)
                rec = profiling.last_dispatch_record()
                ev = events[-1]
                host_s = ev["launch_s"] + ev["wait_s"] + ev["readback_s"]
                assert 0 < rec["device_s"] <= host_s, (rec["device_s"], host_s)
                assert rec["devices"] == ["cuda:0"] and rec["binding_ceiling"]
        finally:
            tpe_device._suggest_observers.remove(also_events)
    assert stats.n_dispatches == 3
    assert stats.summary()["memory"]["backend_peak_bytes"] > 0


def test_service_batched_dispatch_on_card(cuda, monkeypatch):
    """Two studies' suggests held until both are queued, then served by
    ``OptimizationService(device="cuda")`` as ONE batched dispatch: the
    pair-score kernel launched 2 x 2 times (two unquantized families per
    study), and each study's docs equal its unbatched suggest on the card
    from the same history and seed."""
    import copy
    import threading
    import time

    import chip_smoke as cs
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.fmin import space_eval
    from hyperopt_tpu_torch.service import OptimizationService

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # the pair-score kernel
    space = cs.bench_space(T.hp)
    ap = {"n_startup_jobs": 4, "n_EI_candidates": 1024}
    svc = OptimizationService(root=None, device="cuda", batch_window=0.05, warmup=False)
    gate, results, errors = threading.Event(), {}, []
    try:
        for i, sid in enumerate(("a", "b")):
            svc.create_study(sid, space, seed=i, algo="tpe", algo_params=ap)
            for _ in range(6 + 3 * i):  # different history sizes on purpose
                (t,) = svc.suggest(sid)
                svc.report(sid, t["tid"], loss=cs.bench_objective(space_eval(space, t["vals"])))
        expected = {}
        for sid in ("a", "b"):
            study = svc.registry.get(sid)
            seed = int(copy.deepcopy(study.rstate).integers(2 ** 31 - 1))
            trials = T.trials_from_docs(copy.deepcopy(study.trials._dynamic_trials))
            tid = len(trials.trials)
            (doc,) = T.tpe.suggest([tid], study.domain, trials, seed, device="cuda", **ap)
            expected[sid] = {k: v[0] for k, v in doc["misc"]["vals"].items() if v}
        svc.scheduler.call_soon(lambda: gate.wait(60))  # hold the scheduler

        def call(sid):
            try:
                results[sid] = svc.suggest(sid, timeout=120)
            except Exception as e:  # pragma: no cover - debug aid
                errors.append(e)

        threads = [threading.Thread(target=call, args=(sid,)) for sid in ("a", "b")]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while len(svc.scheduler._queue) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(svc.scheduler._queue) == 2
        dispatches = svc.stats.summary()["n_dispatches"]
        before = pair_score_batched.launches
        gate.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert svc.stats.summary()["n_dispatches"] == dispatches + 1
        assert pair_score_batched.launches - before == 2 * 2
        for sid in ("a", "b"):
            assert results[sid][0]["vals"] == expected[sid]
    finally:
        gate.set()
        svc.close()


def test_replica_takeover_prewarms_on_card_and_continues_the_trajectory(cuda, monkeypatch,
                                                                        tmp_path):
    """Two replicas on one card share a root; the owner of a study stops
    (its replica set's heartbeat and reaper halted, its lease left to
    expire, its scheduler closed).  The survivor adopts the study: the
    takeover's pre-warm launches the pair-score kernel on the survivor's
    scheduler thread, and the study's next trials equal an unmigrated
    twin's on the card, value for value.  Both replicas live in this one
    process, which shares one warm-key set; the survivor's is cleared at
    the crash, as a process of its own would start without the victim's."""
    import time

    import chip_smoke as cs
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.algos import tpe_device
    from hyperopt_tpu_torch.fmin import space_eval
    from hyperopt_tpu_torch.service import OptimizationService

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # the pair-score kernel
    space = cs.bench_space(T.hp)
    ap = {"n_startup_jobs": 4, "n_EI_candidates": 1024}
    n_pre, n_post = 10, 4  # every suggest after the crash in one history bucket (16)

    def serve(svc, n):
        out = []
        for _ in range(n):
            (t,) = svc.suggest("mig")
            out.append(t["vals"])
            svc.report("mig", t["tid"], loss=cs.bench_objective(space_eval(space, t["vals"])))
        return out

    twin = OptimizationService(root=None, device="cuda", batch_window=0.001, warmup=False)
    try:
        twin.create_study("mig", space, seed=3, algo="tpe", algo_params=ap)
        want = serve(twin, n_pre + n_post)
    finally:
        twin.close()
    root = str(tmp_path / "root")
    kw = dict(root=root, device="cuda", replica_ttl=2.0, batch_window=0.001, warmup=False)
    s1 = OptimizationService(replica_id="r1", advertise_url="http://r1", **kw)
    s2 = OptimizationService(replica_id="r2", advertise_url="http://r2", **kw)
    try:
        s1.create_study("mig", space, seed=3, algo="tpe", algo_params=ap)
        got = serve(s1, n_pre)
        s1.replica_set._stop.set()  # the crash: no release, no more renewals
        s1.scheduler.close(timeout=60)
        monkeypatch.setattr(tpe_device, "_warm_keys", set())
        before = pair_score_batched.launches
        deadline = time.monotonic() + 120
        while not s2.replica_set.stats.takeovers() and time.monotonic() < deadline:
            time.sleep(0.05)
        (rec,) = s2.replica_set.stats.takeovers()
        assert rec["ok"] and rec["fsck_clean"] and rec["from_owner"] == "r1", rec
        assert rec["prewarm"]["warm"] >= 1 and rec["prewarm"]["error"] == 0, rec
        assert pair_score_batched.launches - before >= 2  # the pre-warm, on the card
        cold = s2.stats.summary()["n_cold_suggests"]
        got += serve(s2, n_post)
        assert s2.stats.summary()["n_cold_suggests"] == cold
        assert s2.replica_set.stats.get("renew_lost") == 0
    finally:
        s1.close()
        s2.close()
    assert got == want


# -- mesh execution: the partials launch and the sharded scorer on the card --


@pytest.mark.parametrize("shape", [
    dict(L=2, C=8192, kb=33, ka=16385, real_a=10001),  # the main path at 10k history
    dict(L=2, C=70, kb=1, ka=40),
    dict(L=3, C=1000, kb=3, ka=1025, real_a=900),  # a below region smaller than sp=4
])
def test_pair_lse_partials_on_card(cuda, shape):
    """The partials launch against its plain version (both regions), its
    difference equal to the pair-score kernel's scores bit for bit, and the
    shards of sp = 2 and 4 (Kb < sp in the last case) combined against the
    unsharded kernel."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials
    from hyperopt_tpu_torch.ops.score import pair_lse_partials as plain_partials
    from hyperopt_tpu_torch.parallel import sharding

    z, params = case(seed=1, **shape)
    z, params = z.to(cuda), params.to(cuda)
    kb = shape["kb"]
    before = pair_lse_partials.launches
    got = pair_lse_partials(z, params, kb)
    scores = pair_score_batched(z, params, kb)
    torch.cuda.synchronize()
    assert pair_lse_partials.launches == before + 1 and got.shape == (2,) + tuple(z.shape)
    ref = plain_partials(z, params, kb)
    ref64 = plain_partials(z.double(), params.double(), kb)
    for r in range(2):
        assert_close_to_plain(got[r], ref[r], ref64[r])
    assert torch.equal((got[0] - got[1]).view(torch.int32), scores.view(torch.int32))
    ref_s, ref64_s = pair_score(z, params, kb), pair_score(z.double(), params.double(), kb)
    for sp in (2, 4):
        shards, wb = sharding._region_shards(params, kb, sp)
        combined = sharding.lse_combine([pair_lse_partials(z, p, wb) for p in shards])
        assert_close_to_plain(combined[0] - combined[1], ref_s, ref64_s)


def test_virtual_mesh_scores_on_card(cuda):
    """A virtual 2×2 mesh on one card (each slot its own stream): the
    sharded scorer's scores against the unsharded kernel's at the main
    path's shape, one partials launch per slot."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials
    from hyperopt_tpu_torch.parallel import sharding

    z, params = case(seed=2, L=2, C=8192, kb=33, ka=16385, real_a=10001)
    z, params = z.to(cuda), params.to(cuda)
    mesh = sharding.DeviceMesh([cuda] * 4, shape=(2, 2))
    streams = {mesh.slot_stream(i, j) for i, j in mesh.local_slots()}
    assert len(streams) == 4 and torch.cuda.current_stream() not in streams
    before = pair_lse_partials.launches
    got = sharding.make_sharded_pair_score_batched(mesh)(z, params, 33)
    ref = pair_score_batched(z, params, 33)
    torch.cuda.synchronize()
    assert pair_lse_partials.launches == before + 4
    ref_plain, ref64 = pair_score(z, params, 33), pair_score(z.double(), params.double(), 33)
    assert_close_to_plain(got, ref_plain, ref64)
    assert_close_to_plain(got, ref, ref64)


def test_all_padding_region_adds_exactly_zero_on_card(cuda):
    """A shard whose below block is only padding: the kernel's partial is
    near NEG_BIG and the combine has the same bits with and without it."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_lse_partials
    from hyperopt_tpu_torch.parallel import sharding

    z, params = case(seed=3, L=2, C=500, kb=2, ka=300)
    z, params = z.to(cuda), params.to(cuda)
    shards, wb = sharding._region_shards(params, 2, 4)
    parts = [pair_lse_partials(z, s, wb) for s in shards]
    torch.cuda.synchronize()
    dead = [i for i, s in enumerate(shards) if bool((s[:, 2, :wb] == -1e30).all())]
    assert dead == [2, 3] and all(bool((parts[i][0] < -1e29).all()) for i in dead)
    with_dead = sharding.lse_combine([p[0] for p in parts])
    without = sharding.lse_combine([p[0] for i, p in enumerate(parts) if i not in dead])
    assert torch.equal(with_dead.view(torch.int32), without.view(torch.int32))


def test_device_sample_batch_on_card_without_a_sync(cuda):
    """The draw stays on the card: under the sync debug mode "error" any
    readback or synchronizing copy would raise.  Read back afterwards, it
    equals ``sample_batch``'s draw at the same seed."""
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.vectorize import CompiledSpace

    space = {
        "lr": T.hp.loguniform("lr", np.log(1e-5), np.log(1.0)),
        "width": T.hp.quniform("width", 32, 1024, 32),
        "arch": T.hp.choice("arch", [{"d": T.hp.normal("d", 0, 3)}, {"k": T.hp.randint("k", 7)}]),
    }
    cs = CompiledSpace(space)
    cs.device_sample_batch(0, 16)  # warm the allocator and the generator outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, active = cs.device_sample_batch(5, 4096)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.is_cuda for v in vals.values()) and all(a.is_cuda for a in active.values())
    ref_vals, ref_active = cs.sample_batch(5, 4096)
    for lb in vals:
        assert np.array_equal(vals[lb].cpu().numpy(), ref_vals[lb])
        assert np.array_equal(active[lb].cpu().numpy(), ref_active[lb])


def test_checkpointed_fmin_on_card(cuda, tmp_path):
    """``fmin(trials_save_file='*.orbax')`` on the card: 8 trials saved,
    resumed in a fresh ``Trials`` to 24 with the same ``rstate`` stream,
    trial for trial the uninterrupted run."""
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.checkpoint import TrialsCheckpointer

    space = {"x": T.hp.uniform("x", -5, 5), "c": T.hp.choice("c", [0, 1, 2])}

    def loss(p):
        return (p["x"] - 1.0) ** 2 + p["c"]

    path = str(tmp_path / "run.orbax")
    rstate = np.random.default_rng(3)
    T.fmin(loss, space, max_evals=8, trials=T.Trials(), trials_save_file=path,
           rstate=rstate, show_progressbar=False)
    resumed = T.Trials()
    T.fmin(loss, space, max_evals=24, trials=resumed, trials_save_file=path,
           rstate=rstate, show_progressbar=False)
    whole = T.Trials()
    T.fmin(loss, space, max_evals=24, trials=whole, rstate=np.random.default_rng(3),
           show_progressbar=False)
    assert [d["misc"]["vals"] for d in resumed.trials] == [d["misc"]["vals"] for d in whole.trials]
    assert len(TrialsCheckpointer(path).restore().trials) == 24


def test_train_atpe_corpus_build_launches_the_kernel_on_card(cuda, monkeypatch):
    """``train_atpe.build_corpus`` at the ``--quick`` sizes on the card
    (2 domains, seed 0, checkpoint 20, 6 configs of 6 continuation evals):
    2 rows with finite features and labels inside the grid, no tensor in
    a row, the pair-score kernel launched by the TPE suggests, and the
    kernel equal to its plain version on the first input of each shape the
    build gave it."""
    import math

    from hyperopt_tpu_torch.algos import tpe_device
    from hyperopt_tpu_torch.algos.atpe import FEATURE_NAMES
    from hyperopt_tpu_torch.models import train_atpe as ta

    kept = {}

    def keeping(z, params, k_below):
        kept.setdefault((*z.shape, params.shape[-1], int(k_below)),
                        (z.clone(), params.clone(), int(k_below)))
        return pair_score_batched(z, params, k_below)

    monkeypatch.setattr(tpe_device, "pair_score_batched", keeping)
    before = pair_score_batched.launches
    rows = ta.build_corpus(["quadratic1", "gauss_wave2"], [0], (20,), 6, 6,
                           log=lambda line: None, device="cuda")
    torch.cuda.synchronize()
    assert pair_score_batched.launches > before
    assert kept
    for z, params, k_below in kept.values():
        assert_close_to_plain(pair_score_batched(z, params, k_below),
                              pair_score(z, params, k_below),
                              pair_score(z.double(), params.double(), k_below))
    assert len(rows) == 2 and ta._tensor_path(rows) is None
    for feats, labels in rows:
        assert all(math.isfinite(feats[k]) for k in FEATURE_NAMES)
        assert min(ta.GRID["gamma"]) <= labels["gamma"] <= max(ta.GRID["gamma"])
        assert labels["result_filtering_mode"] in dict(ta.GRID["result_filtering"])
