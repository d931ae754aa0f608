"""The port's roofline profiler (``hyperopt_tpu_torch.profiling``) against
the JAX package's ``tests/test_profiling.py``: the roofline math on the
card's ceilings, ``pair_score_cost`` and ``analytical_cost`` equal to the
reference's for the same requests, the observer wiring (one record per
resolved dispatch, the completion event once per resolved dispatch and
with ``error: True`` on a failed readback, nothing for an unresolved
speculation, nothing left installed), ``DeviceStats`` aggregation and the
bounded ``torch.profiler`` capture.  Everything on the CPU, where
``device_s`` is the reference's host-observed figure."""

import os

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import profiling as jprof
from hyperopt_tpu.ops import score as jscore
from hyperopt_tpu_torch import profiling
from hyperopt_tpu_torch.algos import tpe, tpe_device
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK, Domain
from hyperopt_tpu_torch.observability import DeviceStats, render_prometheus
from hyperopt_tpu_torch.ops import score as tscore
from hyperopt_tpu_torch.resilience import is_device_error


def _mixed_space(hp, tag="x"):
    return {
        f"lr_{tag}": hp.loguniform(f"lr_{tag}", np.log(1e-4), np.log(1.0)),
        f"mom_{tag}": hp.uniform(f"mom_{tag}", 0.0, 1.0),
        f"c_{tag}": hp.choice(f"c_{tag}", ["a", "b", "c"]),
    }


def _grown(pkg, tag, n=30, seed=0):
    """``n`` completed trials (the same docs in either package) so suggests
    reach the device plane."""
    domain = pkg.base.Domain(lambda c: 0.0, _mixed_space(pkg.hp, tag))
    rng = np.random.default_rng(seed)
    trials = pkg.Trials()
    docs = []
    for t in range(n):
        vals = {f"lr_{tag}": float(np.exp(rng.uniform(np.log(1e-4), 0.0))),
                f"mom_{tag}": float(rng.uniform()), f"c_{tag}": int(rng.integers(3))}
        docs.append({
            "tid": t, "spec": None, "state": JOB_STATE_DONE,
            "result": {"status": STATUS_OK, "loss": float(rng.standard_normal())},
            "misc": {"tid": t, "cmd": None, "idxs": {k: [t] for k in vals},
                     "vals": {k: [v] for k, v in vals.items()}},
            "owner": None, "book_time": None, "refresh_time": None, "exp_key": None,
        })
    trials._insert_trial_docs(docs)
    trials.refresh()
    return domain, trials


def _suggest(ids, domain, trials, seed, **kw):
    return tpe.suggest(ids, domain, trials, seed, device="cpu", **kw)


# ---------------------------------------------------------------------
# roofline math units
# ---------------------------------------------------------------------


class TestRoofline:
    def test_card_ceilings(self):
        peaks = profiling.platform_peaks("cuda")
        assert peaks["peak_tflops"] == 67.0 and peaks["peak_hbm_GBps"] == 3350.0
        assert peaks["source"] == "h100_sxm_datasheet"
        assert peaks["ridge_ai"] == pytest.approx(67e12 / 3350e9)

    def test_low_intensity_binds_on_bandwidth(self):
        peaks = profiling.platform_peaks("cuda")
        r = profiling.roofline(1e9, 1e9, 0.01, peaks)  # AI 1, ridge 20
        assert r["binding_ceiling"] == "hbm_bw"
        assert r["roofline_pct"] == r["roofline_pct_bw"] != r["roofline_pct_mxu"]

    def test_high_intensity_binds_on_flops(self):
        r = profiling.roofline(1e12, 1e6, 0.01, profiling.platform_peaks("cuda"))
        assert r["binding_ceiling"] == "flops"
        assert r["roofline_pct"] == r["roofline_pct_mxu"]

    def test_gbps_arithmetic(self):
        # exactly 1% of 3,350 GB/s moved in 1 s
        r = profiling.roofline(1.0, 33.5e9, 1.0, profiling.platform_peaks("cuda"))
        assert r["achieved_GBps"] == pytest.approx(33.5)
        assert r["roofline_pct"] == pytest.approx(1.0)

    def test_bandwidth_pct_equals_attainable_flops_pct(self):
        peaks = profiling.platform_peaks("cuda")
        r = profiling.roofline(3e9, 1e9, 0.004, peaks)
        attainable_tflops = 3.0 * peaks["peak_hbm_GBps"] * 1e9 / 1e12
        assert r["roofline_pct"] == pytest.approx(100.0 * r["achieved_tflops"] / attainable_tflops)

    def test_unmeasurable_is_null_never_zero(self):
        peaks = profiling.platform_peaks("cpu")
        for args in ((1e9, 1e9, 0.0), (0.0, 0.0, 1.0)):
            r = profiling.roofline(*args, peaks)
            assert r["binding_ceiling"] is None and r["roofline_pct"] is None

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("HYPEROPT_TPU_PEAK_TFLOPS", "100.0")
        monkeypatch.setenv("HYPEROPT_TPU_PEAK_HBM_GBPS", "1000.0")
        peaks = profiling.platform_peaks("cuda")
        assert (peaks["peak_tflops"], peaks["peak_hbm_GBps"]) == (100.0, 1000.0)
        assert peaks["source"] == "env_override" and peaks["ridge_ai"] == pytest.approx(100.0)

    def test_cpu_peaks_and_math_equal_the_reference(self):
        tp, jp = profiling.platform_peaks("cpu"), jprof.platform_peaks("cpu")
        assert tp == jp and tp["source"] == "nominal_cpu"
        for args in ((1e9, 1e9, 0.01), (1e12, 1e6, 0.01), (3e9, 1e9, 0.004)):
            assert profiling.roofline(*args, tp) == jprof.roofline(*args, jp)

    def test_no_tpu_constants(self):
        assert not any(n.startswith("TPU_") for n in vars(profiling))


# ---------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------


@pytest.mark.parametrize("scorer", ["pallas", "xla", "fused"])
@pytest.mark.parametrize("C,K", [(8192, 16418), (8192, 6144), (65536, 16418)])
def test_pair_score_cost_equals_the_reference(scorer, C, K):
    """At K at or above the reference's TPU crossover (which the port does
    not have) the two models agree on every tier."""
    assert tscore.pair_score_cost(C, K, scorer) == jscore.pair_score_cost(C, K, scorer)


@pytest.mark.parametrize("scorer", ["pallas", "xla", "fused"])
def test_pair_score_cost_below_the_crossover_with_a_forced_tier(scorer, monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_SCORER", scorer)
    assert tscore.pair_score_cost(512, 40, scorer) == jscore.pair_score_cost(512, 40, scorer)
    monkeypatch.delenv("HYPEROPT_TPU_SCORER")
    # unforced, the port keeps the tier: its kernels never materialize [C, K]
    assert tscore.pair_score_cost(512, 40, "pallas")["bytes"] == 4.0 * (3 * 512 + 3 * 40)


def _requests(tag, n_cand, scorer, monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_SCORER", scorer)
    out = []
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        domain, trials = _grown(pkg, tag)
        prep = pkg.tpe.suggest_prepare([1000], domain, trials, 7, n_EI_candidates=n_cand, **kw)
        assert prep is not None
        out.append(prep[0])
    return out


@pytest.mark.parametrize("scorer", ["pallas", "xla", "fused", "exact"])
@pytest.mark.parametrize("n_cand", [256, 1024])
def test_analytical_cost_and_signature_equal_the_reference(scorer, n_cand, monkeypatch):
    jreq, treq = _requests("cm", n_cand, scorer, monkeypatch)
    assert profiling.analytical_cost(treq) == jprof.analytical_cost(jreq)
    key = profiling.signature_key(treq)
    assert key == jprof.signature_key(jreq)
    assert key.startswith("capt") and "cont[" in key and "idx[" in key and f"c{n_cand}" in key
    ana = profiling.analytical_cost(treq)
    if scorer != "exact":
        assert 0 < ana["mxu_flops"] < ana["flops"]


def test_cost_scales_with_candidates(monkeypatch):
    a1 = profiling.analytical_cost(_requests("s1", 256, "pallas", monkeypatch)[1])
    a2 = profiling.analytical_cost(_requests("s2", 1024, "pallas", monkeypatch)[1])
    assert a2["flops"] > 2.0 * a1["flops"] and a2["bytes"] > 1.5 * a1["bytes"]


def test_dispatch_devices_label():
    domain, trials = _grown(T, "dd")
    reqs, _ = tpe.suggest_prepare([100], domain, trials, 1, device="cpu")
    assert profiling.dispatch_devices(reqs) == ["cpu:0"]


# ---------------------------------------------------------------------
# observer wiring
# ---------------------------------------------------------------------


def test_one_record_per_dispatch_and_uninstall():
    domain, trials = _grown(T, "ow")
    rng = np.random.default_rng(3)
    stats = DeviceStats()
    n_before = len(tpe_device._suggest_observers)
    with profiling.DeviceProfiler(stats=stats):
        assert len(tpe_device._suggest_observers) == n_before + 1
        for i in range(4):
            docs = _suggest([500 + i], domain, trials, i + 1)
            for d in docs:
                d["state"] = JOB_STATE_DONE
                d["result"] = {"status": STATUS_OK, "loss": float(rng.standard_normal())}
            trials._insert_trial_docs(docs)
            trials.refresh()
    assert stats.n_dispatches == 4
    assert len(tpe_device._suggest_observers) == n_before
    _suggest([900], domain, trials, 99)
    assert stats.n_dispatches == 4


def test_last_record_consumed_once():
    domain, trials = _grown(T, "lr")
    profiling.last_dispatch_record()  # drain
    with profiling.DeviceProfiler(stats=DeviceStats()):
        _suggest([600], domain, trials, 1)
        rec = profiling.last_dispatch_record()
    assert rec is not None and rec["binding_ceiling"] is not None
    assert rec["roofline_pct"] is not None and rec["device_s"] > 0
    assert rec["hbm_bytes"] > 0 and rec["live_bytes"] > 0
    assert rec["devices"] == ["cpu:0"] and rec["compiled"] is False
    assert rec["cost_source"] == "analytical"
    assert profiling.last_dispatch_record() is None


def _recording_observer(events):
    def observe(requests):
        return events.append
    return observe


def test_completion_fires_once_per_resolved_dispatch_and_never_unresolved():
    domain, trials = _grown(T, "cb")
    events = []
    obs = _recording_observer(events)
    tpe_device._suggest_observers.append(obs)
    try:
        _suggest([700], domain, trials, 1)
        assert len(events) == 1
        ev = events[0]
        assert set(ev) == {"n_requests", "compiled", "launch_s", "wait_s", "readback_s",
                           "device_s", "out_bytes"}
        assert ev["n_requests"] == 3 and ev["out_bytes"] > 0 and ev["device_s"] > 0
        # a speculation launched and never resolved fires nothing
        resolve = tpe.suggest_async([701], domain, trials, 2, device="cpu")
        assert len(events) == 1
        assert len(resolve()) == 1
        assert len(events) == 2
    finally:
        tpe_device._suggest_observers.remove(obs)


class _FailingEvent:
    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_failed_readback_fires_an_error_event_and_raises_a_device_error(monkeypatch):
    """The card reports a kernel's fault at the readback's wait: the
    resolver raises an error the device recovery recognizes, and every
    completion callback gets ``{error: True, ...}`` (a profiler attributes
    nothing to it)."""
    domain, trials = _grown(T, "rb")
    events, stats = [], DeviceStats()
    real = tpe_device._start_readback
    monkeypatch.setattr(tpe_device, "_start_readback",
                        lambda flat: (real(flat)[0], _FailingEvent()))
    obs = _recording_observer(events)
    tpe_device._suggest_observers.append(obs)
    try:
        with profiling.DeviceProfiler(stats=stats):
            with pytest.raises(RuntimeError) as ei:
                _suggest([800], domain, trials, 1)
    finally:
        tpe_device._suggest_observers.remove(obs)
    assert is_device_error(ei.value)
    assert events == [{"error": True, "n_requests": 3, "compiled": False}]
    assert stats.n_dispatches == 0


def test_uninstalled_profiler_leaves_no_observer():
    n = len(tpe_device._suggest_observers)
    prof = profiling.DeviceProfiler().install()
    prof.install()  # idempotent
    assert len(tpe_device._suggest_observers) == n + 1
    prof.uninstall()
    prof.uninstall()
    assert len(tpe_device._suggest_observers) == n == 0


def test_profiler_records_render():
    domain, trials = _grown(T, "pr")
    stats = DeviceStats()
    with profiling.DeviceProfiler(stats=stats):
        _suggest([600], domain, trials, 1)
        _suggest([601], domain, trials, 2)
    s = stats.summary()
    assert s["n_dispatches"] == 2 and s["signatures"][0]["n_dispatches"] == 2
    assert s["per_device"]["cpu:0"]["n_dispatches"] == 2
    text = render_prometheus(device=stats)
    assert "hyperopt_device_dispatches_total 2.0" in text
    assert 'hyperopt_device_binding_dispatches_total{ceiling="hbm_bw"} 2' in text


# ---------------------------------------------------------------------
# the bounded torch.profiler capture
# ---------------------------------------------------------------------


def test_capture_is_bounded(tmp_path):
    domain, trials = _grown(T, "pc")
    cap = profiling.ProfileCapture(str(tmp_path / "prof"), max_dispatches=2)
    with cap:
        for i in range(4):
            _suggest([800 + i], domain, trials, i + 1)
    s = cap.summary()
    assert s["started"] and s["stopped"] and s["n_captured"] == 2
    captured = [f for _, _, fs in os.walk(tmp_path / "prof") for f in fs]
    assert captured
    assert tpe_device._suggest_observers == []


def test_zero_budget_never_arms(tmp_path):
    cap = profiling.ProfileCapture(str(tmp_path), max_dispatches=0)
    n = len(tpe_device._suggest_observers)
    cap.install()
    assert len(tpe_device._suggest_observers) == n
    cap.uninstall()
