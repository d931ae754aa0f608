"""The port's telemetry (``hyperopt_tpu_torch.observability``) against the
JAX package's: ``PhaseTimings``, ``quantile_from_counts`` and
``LatencyHistogram``, ``DeviceStats`` and ``StoreStats`` fed the same
events (and the store's own record sites driven by the same queue
operations) give equal snapshots; ``render_prometheus`` renders the same
text for the same stats (apart from the identity gauge's labels) and
passes the reference's exposition validator
(``tests/test_prometheus_exposition.py``) on every section that needs no
control-plane stats; ``FMinIter.timings`` times the same phases as the
reference's driver; ``traced_suggest`` and ``annotate`` run under
``torch.profiler``."""

import math
import os
from functools import partial

import numpy as np
import pytest
from test_prometheus_exposition import parse_exposition

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import observability as jo
from hyperopt_tpu.parallel import file_trials as jft
from hyperopt_tpu_torch import observability as to
from hyperopt_tpu_torch.parallel import file_trials as tft

MODS = (jo, to)


@pytest.fixture(autouse=True)
def _readable_cwd():
    """Threaded queue workers of an earlier test file in this process (the
    JAX package's ``tests/test_file_trials.py``) can leave its cwd in a
    deleted temporary directory; this file's subprocesses and lazy imports
    need a cwd that exists."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield


def test_phase_timings_equal():
    a, b = jo.PhaseTimings(), to.PhaseTimings()
    for t in (a, b):
        for name, s in (("suggest", 0.25), ("evaluate", 1.5), ("suggest", 0.125)):
            t.record(name, s)
        with t.phase("refresh"):
            pass
    sa, sb = a.summary(), b.summary()
    assert sa.keys() == sb.keys() == {"evaluate", "refresh", "suggest"}
    for name in ("evaluate", "suggest"):
        assert sa[name] == sb[name]
    assert sb["suggest"] == {"total_s": 0.375, "count": 2, "mean_ms": 187.5}
    assert sb["refresh"]["count"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_histograms_and_quantiles_equal(seed):
    rng = np.random.default_rng(seed)
    samples = np.exp(rng.normal(-4, 2, 500))
    hists = [m.LatencyHistogram() for m in MODS] + [
        m.LatencyHistogram(m.FSYNC_DURATION_BUCKETS) for m in MODS]
    for h in hists:
        for s in samples:
            h.observe(s)
    for ja, tb in ((hists[0], hists[1]), (hists[2], hists[3])):
        assert ja.state() == tb.state() and ja.to_dict() == tb.to_dict()
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert tb.quantile(q) == ja.quantile(q)
    counts = [int(c) for c in rng.integers(0, 5, len(jo.SUGGEST_DURATION_BUCKETS) + 1)]
    for q in (0.25, 0.5, 0.99):
        assert to.quantile_from_counts(to.SUGGEST_DURATION_BUCKETS, counts, q) == \
            jo.quantile_from_counts(jo.SUGGEST_DURATION_BUCKETS, counts, q)
    assert to.quantile_from_counts((1.0,), [0, 0], 0.5) is None


def _rec(sig="s", device_s=0.01, ceiling="hbm_bw", pct=10.0, compiled=False,
         live=100, n_requests=1, devices=("cuda:0",)):
    return {
        "sig": sig, "n_requests": n_requests, "device_s": device_s,
        "launch_s": device_s / 2, "wait_s": 0.0, "readback_s": device_s / 2,
        "flops": 1e6, "mxu_flops": 5e5, "hbm_bytes": 1e6, "live_bytes": live,
        "cost_source": "analytical", "compiled": compiled, "achieved_tflops": 1e-4,
        "achieved_GBps": 0.1, "ai_flops_per_byte": 1.0, "ridge_ai": 20.0,
        "binding_ceiling": ceiling, "roofline_pct": pct, "roofline_pct_mxu": pct / 2,
        "roofline_pct_bw": pct, "devices": list(devices),
    }


def _device_events(stats):
    stats.record_dispatch(_rec(pct=50.0, compiled=True, device_s=2e6))  # duty clamps to 1
    stats.record_dispatch(_rec(pct=10.0))
    stats.record_dispatch(_rec(pct=20.0, live=5000))
    stats.record_dispatch(_rec(sig="t", ceiling="flops", pct=30.0))
    stats.set_backend_peak_bytes(123456, device="cuda:0")
    stats.set_backend_peak_bytes(999)


def test_device_stats_snapshots_equal():
    a, b = jo.DeviceStats(), to.DeviceStats()
    for st in (a, b):
        _device_events(st)
    sa, sb = a.summary(), b.summary()
    assert sa == sb
    assert sb["n_compile_dispatches"] == 1 and sb["duty_cycle"] == 1.0
    assert sb["binding_ceiling_counts"] == {"flops": 1, "hbm_bw": 3}
    assert sb["roofline_pct_mean"]["hbm_bw"] == pytest.approx(15.0)
    assert sb["memory"] == {"live_buffer_highwater_bytes": 5000, "backend_peak_bytes": 123456}
    assert a.recent_records() == b.recent_records()
    assert a.slo_counters() == b.slo_counters()


def _store_events(st):
    st.record_fsync(0.001, kind="doc", nbytes=512)
    st.record_fsync(3.0, kind="journal", nbytes=128)  # the +Inf bucket
    st.record_doc_write(512)
    st.record_attachment_write(64)
    st.record_scan(10)
    st.record_refresh(local=True)
    st.record_refresh(local=False)
    st.record_journal_append(128)
    st.record_journal_compaction(1000)
    st.record_journal_torn(1)
    st.record_segment_append(3, 900)
    st.record_segment_seal()
    st.record_segment_compaction(2)
    st.record_segment_replay(5, full=True)
    st.record_segment_torn(1)
    st.record_segment_pull(1, 300)
    st.record_lease("grant")
    st.record_quarantine(1)


def test_store_stats_snapshots_equal():
    a, b = jo.StoreStats(), to.StoreStats()
    for st in (a, b):
        _store_events(st)
    assert a.summary() == b.summary()
    assert a.fsync_hist_state() == b.fsync_hist_state()
    assert a.slo_counters() == b.slo_counters() == {"store_bad": 3, "fsyncs_total": 2}


def _queue_ops(ft_mod, root, backend):
    """The same FileTrials operations in one package, with its StoreStats
    installed: inserts, a result write, refreshes, state counts and an
    attachment.  Returns the snapshot's counters (timings left out)."""
    stats = ft_mod_stats = (jo if ft_mod is jft else to).StoreStats()
    ft_mod.set_store_stats(ft_mod_stats)
    try:
        trials = ft_mod.FileTrials(root, backend=backend)
        ids = trials.new_trial_ids(3)
        miscs = [{"tid": t, "cmd": None, "workdir": None, "idxs": {"x": [t]},
                  "vals": {"x": [float(t)]}} for t in ids]
        trials.insert_trial_docs(trials.new_trial_docs(
            ids, [None] * 3, [{"status": "new"} for _ in ids], miscs))
        trials.refresh()
        trials.attachments["note"] = b"x" * 10
        trials.refresh()
    finally:
        ft_mod.set_store_stats(None)
    s = stats.summary()
    return {k: v for k, v in s.items()
            if k not in ("fsync_p50_ms", "fsync_p99_ms", "fsync_sum_s")}


@pytest.mark.parametrize("backend", ["doc", "segment"])
def test_store_record_sites_count_the_same_in_both_packages(tmp_path, backend):
    """``set_store_stats`` in each package and the same queue operations:
    the record calls of the store, segment appends, fsyncs, scans and
    refreshes land as the reference's do."""
    ja = _queue_ops(jft, str(tmp_path / "j"), backend)
    tb = _queue_ops(tft, str(tmp_path / "t"), backend)
    assert tb == ja
    assert tb["fsyncs_total"] > 0 and tb["refresh_full"] + tb["refresh_local"] > 0


def test_native_state_count_records_its_scan(tmp_path):
    """On the doc backend with the native scanner loaded, a state count
    records one directory scan of every doc.  (The reference's same call
    sums the native counts as a dict while the scanner returns a list, and
    raises with a StoreStats installed; the port sums the list.)"""
    from hyperopt_tpu_torch import native

    if native.load_fastqueue() is None:
        pytest.skip("the native scanner does not build here")
    stats = to.StoreStats()
    trials = tft.FileTrials(str(tmp_path), backend="doc")
    ids = trials.new_trial_ids(3)
    miscs = [{"tid": t, "cmd": None, "workdir": None, "idxs": {"x": [t]},
              "vals": {"x": [float(t)]}} for t in ids]
    trials.insert_trial_docs(trials.new_trial_docs(
        ids, [None] * 3, [{"status": "new"} for _ in ids], miscs))
    tft.set_store_stats(stats)
    try:
        assert trials.count_by_state_unsynced(0) == 3
    finally:
        tft.set_store_stats(None)
    assert stats.summary()["scans"] == 1 and stats.summary()["scan_entries"] == 3


def _stats(mod):
    timings = mod.PhaseTimings()
    timings.record("suggest", 0.5)
    timings.record("evaluate", 2.0)
    spec = mod.SpeculationStats()
    spec.record_dispatch(0.1)
    spec.record_sync(0.2)
    spec.record_resolve(0.01)
    faults = mod.FaultStats()
    faults.record("lease_expired")
    faults.record('chaos_torn_doc"quoted\\path')  # escaping exercise
    faults.record_backoff(0.7)
    device = mod.DeviceStats()
    _device_events(device)
    store = mod.StoreStats()
    _store_events(store)
    return dict(timings=timings, speculation=spec, faults=faults, device=device,
                store=store)


STUDY_HEALTH = {
    "rows": [{"study": 'zoo"1\\x', "best_loss": 0.5, "regret": None, "gamma": 0.25,
              "n_below": 4, "ei_max": 1.5, "ei_flatness": 0.3, "state": "OK"}],
    "truncated_total": 7,
}
SLO_ROWS = [
    {"rule": "SL601", "status": "ok", "burn_fast": 0.1, "burn_slow": 0.05,
     "breaches_total": 0},
    {"rule": "SL605", "status": "breach", "burn_fast": 2.0, "burn_slow": None,
     "breaches_total": 3},
]


def _render(mod, **extra):
    return mod.render_prometheus(**_stats(mod), study_health=STUDY_HEALTH, slo=SLO_ROWS,
                                 build=mod.build_info(),
                                 extra={"service_uptime_seconds": 12.5}, **extra)


def _without_build(text):
    return "\n".join(l for l in text.split("\n") if not l.startswith("hyperopt_build_info{"))


def test_render_equals_the_reference_apart_from_build_info():
    jt, tt = _render(jo), _render(to)
    assert _without_build(tt) == _without_build(jt)
    # the service and control sections render the reference's objects
    # (their classes arrive with the service slice) exactly as it does
    from hyperopt_tpu.control import ControlStats

    service = jo.ServiceStats()
    service.record_request("suggest", seconds=0.02, study='s"tricky\\1')
    service.record_dispatch(4, 0.1)
    control = ControlStats()
    control.record_decision("applied")
    control.set_objective(0.125)
    kw = dict(service=service, control=control.control_metrics())
    assert to.render_prometheus(**kw) == jo.render_prometheus(**kw)


def test_render_passes_the_exposition_validator():
    families = parse_exposition(_render(to))
    assert len(families) > 30
    seen = set()
    for fam, rec in families.items():
        assert rec["samples"], fam
        if rec["type"] == "counter":
            assert fam.endswith("_total"), fam
        for name, labels, _ in rec["samples"]:
            assert (name, labels) not in seen
            seen.add((name, labels))
    for fam in ("hyperopt_store_fsync_duration_seconds",):
        rec = families[fam]
        buckets = [(dict(lb)["le"], float(v)) for n, lb, v in rec["samples"]
                   if n == f"{fam}_bucket"]
        (count,) = [float(v) for n, _, v in rec["samples"] if n == f"{fam}_count"]
        assert [v for _, v in buckets] == sorted(v for _, v in buckets)
        assert buckets[-1] == ("+Inf", count)
    burns = {(dict(lb)["rule"], dict(lb)["window"]): v
             for _, lb, v in families["hyperopt_slo_burn_rate"]["samples"]}
    assert burns[("SL605", "slow")] == "NaN" and not math.isnan(float(burns[("SL601", "fast")]))


def test_build_info_identity_gauge_names_torch_and_cuda():
    families = parse_exposition(_render(to))
    ((_, labels, value),) = families["hyperopt_build_info"]["samples"]
    keys = dict(labels)
    assert set(keys) == {"version", "torch", "cuda", "backend"}
    assert float(value) == 1.0
    info = to.build_info()
    assert info["version"] == T.__version__ == J.__version__
    # CUDA is never initialized by a render
    assert info["backend"] == "uninitialized" and info["cuda"] == keys["cuda"]


def _fmin_timings(pkg, k):
    algo = (partial(T.rand.suggest, device="cpu") if pkg is T else J.rand.suggest)
    domain = pkg.base.Domain(lambda c: (c["x"] - 1.0) ** 2, {"x": pkg.hp.uniform("x", -5, 5)})
    it = pkg.FMinIter(algo, domain, pkg.Trials(), rstate=np.random.default_rng(0),
                           max_evals=6, max_speculation=k, show_progressbar=False)
    it.exhaust()
    return {name: st["count"] for name, st in it.timings.summary().items()}, \
        [t["misc"]["vals"]["x"] for t in it.trials.trials]


@pytest.mark.parametrize("k", [0, 1])
def test_fmin_iter_timings_phases_equal_the_reference(k):
    """The driver times the same phases, as many times, as the reference's
    (serial loop at k=0; the pipelined engine at k=1 where rand is
    speculated), on the same run."""
    jt, jvals = _fmin_timings(J, k)
    tt, tvals = _fmin_timings(T, k)
    assert tt == jt and set(tt) == {"suggest", "evaluate"} and tt["suggest"] == 6
    assert len(tvals) == len(jvals) == 6


def test_timed_traced_suggest_and_annotate(tmp_path):
    timings = to.PhaseTimings()
    algo = to.timed_suggest(partial(T.rand.suggest, device="cpu"), timings)
    domain = T.base.Domain(lambda c: 0.0, {"x": T.hp.uniform("x", 0, 1)})
    trials = T.Trials()
    docs = algo([0], domain, trials, 1)
    assert len(docs) == 1 and timings.summary()["suggest"]["count"] == 1
    traced = to.traced_suggest(partial(T.rand.suggest, device="cpu"), tmp_path / "trace")
    with to.annotate("suggest-region"):
        assert len(traced([1], domain, trials, 2)) == 1
    written = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert written and all(f.endswith(".json") for f in written)
