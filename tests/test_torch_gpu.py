"""Card-only checks of the port's CUDA kernel (marker ``gpu``).

Run on a machine with a CUDA card: ``pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``--noconftest``: ``tests/conftest.py`` sets JAX up, and the port needs no JAX).
Without a card every test here skips; whether a card is present is decided
inside the ``cuda`` fixture, never at import.
"""

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

    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "pallas")  # no probe: the pair-score kernel
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
