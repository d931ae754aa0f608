"""CPU tests of the port's benchmark harness (``portbench/``).

Run from the checkout's root:  python3 -m pytest portbench/tests -q
The test marked ``gpu`` runs one cell on a card and skips without one.
"""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.core import drivers, history, spaces  # noqa: E402
from portbench.core.registry import HERE, Bench, load_module  # noqa: E402
from portbench.core.trace import Spans, SliceTracer, breakdown  # noqa: E402
from portbench.reference import control  # noqa: E402
from portbench.reference import tpe_reference as ref  # noqa: E402

BENCH = Bench(ROOT)
CELLS = sorted(BENCH.cells)
FMIN_CELL = next(c for c in CELLS if BENCH.traffic(BENCH.cells[c]["traffic"])["driver"] == "fmin")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]

def small(history=300, cand=256):
    """A patch that runs a cell at a size the CPU holds, with no history
    bucket to warm."""
    def patch(ctx):
        ctx.cfg["history"] = history
        ctx.algo["n_EI_candidates"] = cand
        ctx.traffic["warm_reach"] = 0
    return patch


def cpu_run(cell, seed=11, seconds=2.0, patch=None, extra=None):
    def both(ctx):
        (patch or small())(ctx)
        if extra is not None:
            extra(ctx)
    return R.run_cell(BENCH, cell, seed, seconds, False, device="cpu", patch=both, sample=40)


# -- registry ---------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    w = BENCH.cell(cell)
    cfg, loss_module = BENCH.config(w["config"])
    assert cfg["name"] == w["config"]
    assert callable(loss_module.loss)
    assert BENCH.traffic(w["traffic"])["driver"] in drivers.DRIVERS
    limits = BENCH.limits(cell)
    assert set(limits) >= {"failed", "out_of_support", "loss_mismatch", "winner_deficit_p90"}


@pytest.mark.parametrize("entry", BENCH.spec["end_to_end"] + BENCH.spec["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(entry):
    mod = BENCH.metric(entry["name"])
    assert callable(mod.read)
    if "moves" in entry:
        assert mod.MOVES == entry["moves"]
        e2e = {m["name"]: m for m in BENCH.spec["end_to_end"]}
        for cell in entry["workloads"]:
            assert cell in BENCH.cells
            assert "workloads" not in e2e[entry["moves"]] or cell in e2e[entry["moves"]]["workloads"]


def test_benchmark_json_keeps_the_contract_shape():
    spec = BENCH.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


# -- the result line ----------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_gives_the_result_line(cell):
    result, rows, run = cpu_run(cell)
    assert list(result) == RESULT_KEYS
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    e2e = {m["name"] for m in BENCH.metrics_for(cell, False)}
    assert set(result["metrics"]) == e2e
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(R._finite(result), allow_nan=False)


def test_a_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        FMIN_CELL, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert p.returncode == R.EXIT_NO_CARD
    assert p.stdout.strip() == ""


def test_a_directory_without_the_program_fails(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(HERE), str(tmp_path / "portbench")], check=True)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", FMIN_CELL,
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_slice_reader_and_breakdown():
    """Device intervals mapped by the anchors, busy time as their union,
    idle time named by the covering host span."""
    tr = SliceTracer(torch, 0.0, 1.0)
    ns = 10 ** 9
    events = [("spin_kernel", 5 * ns, 5 * ns + 10), ("k1", 5 * ns + ns // 10, 5 * ns + ns // 5),
              ("k2", 5 * ns + ns // 10, 5 * ns + 3 * ns // 10), ("Memcpy HtoD", 5 * ns + ns // 2,
                                                                   5 * ns + 6 * ns // 10),
              ("spin_kernel", 6 * ns, 6 * ns + 10)]
    tr.raw = (events, 100.0, 101.0, 100.0, 101.0)
    spans = Spans()
    spans.add("objective", 100.3, 100.5)
    sl = tr.read(spans, ["objective", "fmin"])
    assert math.isclose(sl["busy_s"], 0.3, abs_tol=1e-9)
    assert sl["kernels"] == 2
    assert math.isclose(sl["gaps"]["objective"], 0.2, abs_tol=1e-9)
    assert math.isclose(sl["gaps"]["other"], 0.5, abs_tol=1e-9)
    b = breakdown(sl)
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) == 2


# -- imports --------------------------------------------------------------


def _top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    names = _top_imports(path)
    assert not names & {"jax", "jaxlib", "flax", "hyperopt_tpu"}, names
    if "reference" in path.parts or "cost" in path.parts:
        assert "hyperopt_tpu_torch" not in names


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from portbench.tests import "
            "test_portbench_harness as t; t.cpu_run(t.FMIN_CELL, seconds=1.0); "
            "from portbench import run; print(run.forbidden_modules())" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# -- the yardstick ----------------------------------------------------------


def test_pair_score_cost_at_the_main_path():
    cost = load_module(HERE / "cost" / "pair_score.py", "t_cost")
    ops, nbytes = cost.launch_cost(2, 8192, 16418)
    assert round(cost.bound_s(ops, nbytes) * 1e3, 4) == 0.0321
    nb, na = cost.split(10_000, 0.25, 25)
    assert (nb, na) == (25, 9975)
    cfg, _ = BENCH.config("hpobench-xgb-h10k")
    launches = cost.suggest_launches(cfg["labels"], cfg["algo"], 10_000)
    assert launches == [cost.launch_cost(2, 8192, 10_002), cost.launch_cost(1, 8192, 10_002)]
    assert launches[0][0] == 8 * 2 * 8192 * 10_002
    fused = load_module(HERE / "cost" / "fused_suggest.py", "t_cost_fused")
    assert [x[0] for x in fused.suggest_launches(cfg["labels"], cfg["algo"], 10_000)] == \
        [x[0] for x in launches]


@pytest.mark.parametrize("kernels", [("pair_score_kernel",),
                                     ("fused_tile_kernel", "fused_merge_kernel"), ()],
                         ids=["pair_score", "fused_suggest", "neither"])
def test_the_scorer_roofline_reads_whichever_kernel_ran(kernels):
    """The probe puts #1 or #2 on the path: the roofline reads for either,
    at 100% when every launch takes its least time, and nothing when
    neither kernel ran."""
    mod = BENCH.metric("scorer_kernel_roofline")
    cfg, _ = BENCH.config("hpobench-xgb-h10k")
    cost = mod.COSTS[0] if kernels == ("pair_score_kernel",) else mod.COSTS[1]
    launches = cost.suggest_launches(cfg["labels"], cfg["algo"], 10_000)
    intervals, t = [("other_kernel", 0.0, 1.0)], 1.0
    for _ in range(3):   # three suggests
        for k in kernels:
            for ops, nbytes in launches:
                d = cost.bound_s(ops, nbytes) / cost.LAUNCHES_PER_FAMILY
                intervals.append((f"void {k}<8>(float const*)", t, t + d))
                t += d
    run = {"kind": "fmin", "cfg": cfg,
           "slice": {"kernel_intervals": intervals, "history": 10_000.0}}
    value = mod.read(run)
    if not kernels:
        assert value is None
    else:
        assert math.isclose(value, 100.0, rel_tol=1e-9)
        intervals.append((f"void {kernels[0]}<8>(float const*)", t, t + (t - 1.0)))
        assert value > mod.read(run) > 0


@pytest.mark.parametrize("config", sorted(BENCH.configs))
def test_history_is_the_seeds_and_in_support(config):
    """The same seed gives the same history byte for byte, another seed
    another; every value lies in its label's support; the study after its
    prior draws is a TPE study that improves on them."""
    cfg, loss_module = BENCH.config(config)
    seed = 2 ** 31 + 77
    loss = loss_module.loss

    def make(s):
        return history.make_history(cfg["labels"], loss, s, 1, 500, "cpu",
                                    cfg["history_workers"])
    a, b, c = make(seed), make(seed), make(seed + 1)
    for lab in cfg["labels"]:
        k = lab["label"]
        assert a[0][k].tobytes() == b[0][k].tobytes()
        assert all(spaces.in_support(lab, v) for v in a[0][k]), k
    assert a[1].tobytes() == b[1].tobytes() and a[1].tobytes() != c[1].tobytes()
    assert np.all(np.isfinite(a[1])) and np.all(a[1].astype(np.float32) == a[1])
    startup = history.UPSTREAM["n_startup_jobs"]
    assert np.median(a[1][-100:]) < np.median(a[1][:startup])


# -- the reference -------------------------------------------------------------


def test_reference_parzen_by_hand():
    """obs 0.2, 0.5, 0.9 with the prior N(0.5, 1): the prior sorts before
    the equal observation; neighbour gaps 0.3, -, 0.4, 0.4; the floor is
    1/min(100, 5) = 0.2; equal weights."""
    w, mu, sigma = ref.adaptive_parzen([0.9, 0.2, 0.5], 1.0, 0.5, 1.0, 25)
    assert np.allclose(mu, [0.2, 0.5, 0.5, 0.9])
    assert np.allclose(sigma, [0.3, 1.0, 0.4, 0.4])
    assert np.allclose(w, [0.25] * 4)
    assert np.allclose(ref.forgetting_weights(30, 25)[:5], np.linspace(1 / 30, 1, 5))
    assert ref.below_mask(np.array([3.0, 1.0, 2.0, 1.0]), 0.25, 25).tolist() == \
        [False, True, False, False]


def test_reference_deficit_by_hand():
    """A categorical label: the best category W with probability p under
    l gives U = (1-p)^C + u (1 - (1-p)^C); the second best, with q above
    it, U = (1-p-q)^C + u ((1-q)^C - (1-p-q)^C)... here p = 0.5 for the
    best (b), q for the runner-up."""
    lab = {"label": "x", "dist": "choice", "options": [0, 1, 2]}
    vals = np.array([0, 1, 1, 2, 2, 2, 0, 0])
    losses = np.array([5.0, 0.0, 1.0, 9.0, 9.0, 9.0, 9.0, 9.0])
    m = ref.LabelModel(lab, vals, ref.below_mask(losses, 0.25, 25), {}, "cpu")
    # n_below = ceil(0.25 * sqrt(8)) = 1: below {1}; pseudocounts 3 * 1/3 = 1
    assert np.allclose(m.pb, [1 / 4, 2 / 4, 1 / 4])
    assert np.allclose(m.pa, np.array([4, 2, 4]) / 10)
    C, u = 8, 0.3
    # scores: log(.25/.4), log(.5/.2), log(.25/.4): category 1 is best
    expect = -math.log((1 - 0.5) ** C + u * (1 - (1 - 0.5) ** C))
    assert math.isclose(m.deficit(1, C, u), expect, rel_tol=1e-12)
    # 0 and 2 tie below 1: P_gt = 0.5, P_eq = 0.5
    expect = -math.log(0.0 + u * ((1 - 0.5) ** C - 0.0))
    assert math.isclose(m.deficit(0, C, u), expect, rel_tol=1e-12)
    assert m.deficit(7, C, u) == math.inf


def test_continuous_deficit_is_exponential_for_the_reference_itself():
    """The reference's own exact argmax reads as the best of C draws:
    deficits of mean ~1; the best of C/8 reads ~8."""
    cfg, lm = BENCH.config("hpobench-xgb-h10k")
    loss = lm.loss
    vals, losses = history.make_history(cfg["labels"], loss, 5, 1, 300, "cpu",
                                        cfg["history_workers"])
    models = [m for m in ref.label_models(cfg["labels"], vals, losses, cfg["algo"], "cpu")
              if m.kind == "continuous"]
    gen = torch.Generator().manual_seed(1)
    full, eighth = [], []
    for _ in range(12):
        for m in models:
            full.append(m.deficit(m.suggest(256, gen), 256, 0.5))
            eighth.append(m.deficit(m.suggest(32, gen), 256, 0.5))
    assert 0.5 < np.mean(full) < 1.6
    assert np.mean(eighth) > 4.0


# -- the control and the faults ---------------------------------------------


def test_the_control_fails_the_limit():
    """The reference in the program's place, scoring in bfloat16, at a size
    the CPU holds: its p90 deficit lies above the cell's limit."""
    cell = BENCH.cell(FMIN_CELL)
    cfg, lm = BENCH.config(cell["config"])
    cfg["history"] = 2000
    loss = lm.loss
    numbers, _ = control.run_control(cfg, loss, 4, 16, "cpu", torch.bfloat16)
    assert numbers["winner_deficit_p90"] > BENCH.limits(FMIN_CELL)["winner_deficit_p90"]


def _alter_winners(ctx):
    """A fault where the answer is produced: each suggest's first
    continuous value replaced by a fresh draw from its prior."""
    from hyperopt_tpu_torch.algos import tpe

    lab = next(x for x in ctx.labels if x["dist"] in spaces.CONTINUOUS)
    rng = np.random.default_rng(0)
    emit = tpe._emit_docs

    def altered(new_ids, domain, trials, chosen_vals, k):
        chosen_vals = dict(chosen_vals)
        chosen_vals[lab["label"]] = spaces.sample_prior(lab, rng, k)
        return emit(new_ids, domain, trials, chosen_vals, k)

    tpe._emit_docs = altered
    ctx.restore = lambda: setattr(tpe, "_emit_docs", emit)


def _half_history(ctx):
    """A fault where half of the batch is left out: every other trial of
    the history is dropped from the fit (the γ split, both mixtures)."""
    from hyperopt_tpu_torch.algos import tpe_device

    keep = tpe_device.DeviceHistory.keep_mask

    def half(self, mask):
        full = keep(self, mask)
        return full & (torch.arange(full.shape[0], device=full.device) % 2 == 0)

    tpe_device.DeviceHistory.keep_mask = half
    ctx.restore = lambda: setattr(tpe_device.DeviceHistory, "keep_mask", keep)


def _stale_losses(ctx):
    """A fault where a step leaves the state unchanged: each trial is
    stored with the loss of the trial before it."""
    FMinIter = ctx.T.FMinIter
    evaluate = FMinIter._evaluate_trial
    last = {}

    def stale(self, spec, c, trial):
        result = dict(evaluate(self, spec, c, trial))
        result["loss"], last["loss"] = last.get("loss", result["loss"]), result["loss"]
        return result

    FMinIter._evaluate_trial = stale
    ctx.restore = lambda: setattr(FMinIter, "_evaluate_trial", evaluate)


@pytest.mark.parametrize("fault", [_alter_winners, _half_history, _stale_losses],
                         ids=["altered", "half-history", "stale-loss"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    holder = {}

    def extra(ctx):
        fault(ctx)
        holder["ctx"] = ctx
    try:
        result, rows, _ = cpu_run(FMIN_CELL, seconds=2.0, extra=extra)
    finally:
        holder["ctx"].restore()
    assert result["correct"] is False, result["check"]


# -- the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_one_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", FMIN_CELL,
                        "--seed", "17", "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line) == RESULT_KEYS and line["device"]["platform"] == "gpu"
