"""The port's mesh execution mode against the JAX package's, on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port side on a
``DeviceMesh`` of 8 ``cpu`` slots (a slot may repeat a device, the port's
counterpart of a virtual device).  Covered:

- each sharded scorer of ``parallel/sharding.py``, fed the same numpy
  inputs as ``hyperopt_tpu.parallel.sharding``'s, at 1×8, 2×4, 4×2 and
  8×1, with a ragged K and a below region smaller than ``sp``
  (``atol=1e-4``, the reference's own tolerance for its sharded scorers);
- the pair-score partials (the shard step) combined against the plain
  pair score, and an all-padding region adding exactly 0;
- ``tests/test_mesh.py``'s cases on the port: the degenerate mesh bit for
  bit, the sharded fmin trajectory equal to the unsharded one, the mixed
  batched dispatch, the two-mesh refusal, ``reset_device_state``, the
  service (serial-fmin reproduction, the per-study override at create),
  the ledger's topology fingerprint and replay, the per-device split;
- the port's sharded suggests against the JAX package's sharded ones
  (JAX's uniforms injected, each step from the same history);
- two processes over gloo forming a 2×2 mesh whose ``sp`` shards cross
  the process boundary, and the same pair scoring again after the process
  group is destroyed and made anew.  This file is those tests' subprocess
  helper: ``python tests/test_torch_mesh.py dist <rank> <port>`` and
  ``python tests/test_torch_mesh.py redist <rank> <port> <port2>``.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dist_helper(rank, port, port2=None):
    """One rank of the two-process check: prints ``DIST_SCORE_OK`` when its
    rows of both scorers equal the single-device scores.  With ``port2``
    it then destroys the process group, joins a new one there and scores
    again on an equal mesh (its groups must be the new world's), printing
    ``REINIT_OK``."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from hyperopt_tpu_torch.ops import gmm
    from hyperopt_tpu_torch.ops.score import pair_params, pair_score
    from hyperopt_tpu_torch.parallel import distributed
    from hyperopt_tpu_torch.parallel.sharding import (
        DeviceMesh,
        make_sharded_pair_score_batched,
        make_sharded_score,
    )

    assert distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=2, process_id=rank, backend="gloo")
    assert torch.distributed.get_world_size() == 2
    assert distributed.is_coordinator() == (rank == 0)
    # the production layout keeps sp inside a process ...
    prod = distributed.global_mesh(shape=(2, 2), local=["cpu", "cpu"])
    assert prod.ranks == (0, 0, 1, 1) and (prod.dp, prod.sp) == (2, 2)
    # ... so the grid is transposed here to put every sp combine across
    # the process boundary
    mesh = DeviceMesh(["cpu"] * 4, shape=(2, 2), ranks=(0, 1, 0, 1))
    assert {mesh.owner(i, j) for i in range(2) for j in range(2) if i == 0} == {0, 1}

    rng = np.random.default_rng(0)  # the same inputs in both processes
    C, K = 8, 16

    def mix():
        w = np.abs(rng.normal(size=K)) + 0.1
        return ((w / w.sum()).astype(np.float32), rng.normal(size=K).astype(np.float32),
                (np.abs(rng.normal(size=K)) + 0.2).astype(np.float32))

    cand = rng.uniform(-2, 2, C).astype(np.float32)
    below, above = mix(), mix()
    t = lambda a: torch.tensor(a)  # noqa: E731
    ref = (gmm.gmm_lpdf(t(cand)[None], *(t(a)[None] for a in below), t([-4.0]), t([4.0]),
                        t([0.0]), False, False)
           - gmm.gmm_lpdf(t(cand)[None], *(t(a)[None] for a in above), t([-4.0]), t([4.0]),
                          t([0.0]), False, False))[0].numpy()
    params = pair_params(*(t(a)[None] for a in below), *(t(a)[None] for a in above))
    z = t(cand)[None].contiguous()
    ref_pair = pair_score(z, params.contiguous(), K).numpy()
    for m in (mesh, prod):
        out = make_sharded_score(m)(t(cand), *map(t, below), *map(t, above), -4.0, 4.0).numpy()
        pair = make_sharded_pair_score_batched(m)(z, params, K).numpy()
        for i in range(m.dp):  # the rows this process holds a slot of
            if m.row_slot(i) is not None:
                rows = slice(i * C // m.dp, (i + 1) * C // m.dp)
                np.testing.assert_allclose(out[rows], ref[rows], atol=1e-4)
                np.testing.assert_allclose(pair[:, rows], ref_pair[:, rows], atol=1e-4)
        # every rank ends with the whole result
        np.testing.assert_allclose(out, ref, atol=1e-4)
    torch.distributed.destroy_process_group()
    print(f"DIST_SCORE_OK rank={rank}", flush=True)
    if port2 is None:
        return 0
    assert distributed.initialize(coordinator_address=f"127.0.0.1:{port2}",
                                  num_processes=2, process_id=rank, backend="gloo")
    again = DeviceMesh(["cpu"] * 4, shape=(2, 2), ranks=(0, 1, 0, 1))
    assert again == mesh
    for g in (again.row_group(0), again.row_group(1), again.all_group()):
        assert torch.distributed.get_process_group_ranks(g) == [0, 1]  # the live world's
    pair = make_sharded_pair_score_batched(again)(z, params, K).numpy()
    np.testing.assert_allclose(pair, ref_pair, atol=1e-4)
    torch.distributed.destroy_process_group()
    print(f"REINIT_OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    assert sys.argv[1] in ("dist", "redist"), sys.argv
    sys.exit(_dist_helper(int(sys.argv[2]), sys.argv[3], *sys.argv[4:5]))

import copy  # noqa: E402
from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import hyperopt_tpu as J  # noqa: E402
import hyperopt_tpu_torch as T  # noqa: E402
from hyperopt_tpu.parallel import sharding as jsh  # noqa: E402
from hyperopt_tpu_torch import compile_ledger  # noqa: E402
from hyperopt_tpu_torch.algos import tpe, tpe_device  # noqa: E402
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK  # noqa: E402
from hyperopt_tpu_torch.ops import pair_kernel  # noqa: E402
from hyperopt_tpu_torch.ops.score import NEG_BIG, pair_lse_partials, pair_params, pair_score  # noqa: E402
from hyperopt_tpu_torch.parallel import sharding as tsh  # noqa: E402
from hyperopt_tpu_torch.parallel.sharding import (  # noqa: E402
    DeviceMesh,
    default_mesh,
    mesh_shape_str,
    resolve_mesh,
)
from test_torch_tpe import jax_streams  # noqa: E402  (JAX's uniforms, for injection)

@pytest.fixture(autouse=True)
def _readable_cwd():
    """Threaded queue workers of an earlier test file in this process (the
    JAX package's ``tests/test_file_trials.py``) can leave its cwd in a
    deleted temporary directory; this file's subprocesses and lazy imports
    need a cwd that exists, and so do the files after it."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(REPO)
    yield


SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
SHAPE_IDS = [f"{dp}x{sp}" for dp, sp in SHAPES]
CPU8 = ["cpu"] * 8

# tests/test_mesh.py's space and algo parameters
SPACE = {
    "x": T.hp.uniform("x", -5, 5),
    "c": T.hp.choice("c", ["a", "b"]),
    "w": T.hp.quniform("w", 0, 10, 1),
}
JSPACE = {
    "x": J.hp.uniform("x", -5, 5),
    "c": J.hp.choice("c", ["a", "b"]),
    "w": J.hp.quniform("w", 0, 10, 1),
}
AP = {"n_startup_jobs": 4, "n_EI_candidates": 32}


def _objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + (0.5 if cfg["c"] == "b" else 0.0) + 0.1 * cfg["w"]


def cpu_mesh(shape=(2, 4)):
    return DeviceMesh(CPU8, shape=shape)


def _history_trials(seed=0, n=8, space=SPACE):
    domain = T.Domain(lambda c: 0.0, space)
    trials = T.Trials()
    rng = np.random.default_rng(seed)
    for i in range(n):
        docs = T.rand.suggest([i], domain, trials, int(rng.integers(2 ** 31 - 1)), device="cpu")
        docs[0]["state"] = JOB_STATE_DONE
        docs[0]["result"] = {"status": STATUS_OK, "loss": float(rng.normal())}
        trials.insert_trial_docs(docs)
        trials.refresh()
    return domain, trials


# ---------------------------------------------------------------------
# the sharded scorers against the JAX package's
# ---------------------------------------------------------------------


def _mixture(rng, k, dead=0):
    w = rng.uniform(0.1, 1.0, k)
    w[k - dead:] = 0.0
    w = w / w.sum()
    return (w.astype(np.float32), rng.normal(0, 2, k).astype(np.float32),
            rng.uniform(0.3, 2.0, k).astype(np.float32))


@pytest.fixture(scope="module")
def scorer_inputs():
    rng = np.random.default_rng(0)
    return {
        "cand": rng.uniform(-4, 4, 40).astype(np.float32),  # some out of [lo, hi)
        "below": _mixture(rng, 13, dead=2),  # ragged K
        "above": _mixture(rng, 21),
        "lo": np.float32(-3.5), "hi": np.float32(3.5),
    }


def _jax_padded(mix, sp):
    total = -(-len(mix[0]) // sp) * sp
    return jsh.pad_mixture(*mix, total)


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_score_equals_jax(scorer_inputs, shape):
    s = scorer_inputs
    jmesh = jsh.default_mesh(shape=shape)
    want = np.asarray(jsh.make_sharded_score(jmesh)(
        s["cand"], *_jax_padded(s["below"], shape[1]), *_jax_padded(s["above"], shape[1]),
        s["lo"], s["hi"]))
    got = tsh.make_sharded_score(cpu_mesh(shape))(
        torch.tensor(s["cand"]), *_t(s["below"]), *_t(s["above"]), s["lo"], s["hi"]).numpy()
    assert np.isnan(want).any() and np.isfinite(want).any()  # both cases covered
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("log_scale", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_quantized_score_equals_jax(scorer_inputs, shape, log_scale):
    s = scorer_inputs
    q = np.float32(0.25)
    if log_scale:
        lo, hi = np.float32(np.log(0.05)), np.float32(np.log(20.0))
        x = np.round(np.exp(s["cand"] * 0.7) / q) * q
    else:
        lo, hi = s["lo"], s["hi"]
        x = np.round(s["cand"] / q) * q
    x = x.astype(np.float32)
    jmesh = jsh.default_mesh(shape=shape)
    want = np.asarray(jsh.make_sharded_quantized_score(jmesh, log_scale)(
        x, *_jax_padded(s["below"], shape[1]), *_jax_padded(s["above"], shape[1]), lo, hi, q))
    got = tsh.make_sharded_quantized_score(cpu_mesh(shape), log_scale)(
        torch.tensor(x), *_t(s["below"]), *_t(s["above"]), lo, hi, q).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _pair_inputs(seed, L=2, C=40, kb=3, ka=22):
    rng = np.random.default_rng(seed)
    b = [np.stack(a) for a in zip(*[_mixture(rng, kb) for _ in range(L)])]
    a = [np.stack(x) for x in zip(*[_mixture(rng, ka, dead=4) for _ in range(L)])]
    params = pair_params(*_t(b), *_t(a)).contiguous()
    z = torch.tensor(rng.uniform(-4, 4, (L, C)).astype(np.float32))
    return z, params, kb


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_pair_score_equals_jax(shape):
    """The label-stacked pair scorer with a below region of 3 components,
    fewer than ``sp`` at 2×4 and 1×8."""
    z, params, kb = _pair_inputs(1)
    K = params.shape[-1]
    pad = -K % shape[1]
    p_np = params.numpy()
    if pad:
        cols = np.zeros((p_np.shape[0], 3, pad), np.float32)
        cols[:, 2] = NEG_BIG
        p_np = np.concatenate([p_np, cols], axis=2)
    want = np.asarray(jsh.make_sharded_pair_score_batched(jsh.default_mesh(shape=shape))(
        z.numpy(), p_np, jnp.int32(kb)))
    got = tsh.make_sharded_pair_score_batched(cpu_mesh(shape))(z, params, kb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, pair_score(z, params, kb).numpy(), atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_best_equals_jax(scorer_inputs, shape):
    s = scorer_inputs
    k, n_cand = 2, 20
    jmesh = jsh.default_mesh(shape=shape)
    jb, ja = _jax_padded(s["below"], shape[1]), _jax_padded(s["above"], shape[1])
    lo, hi = np.float32(-5.0), np.float32(5.0)
    want = np.asarray(jsh.make_sharded_best(jmesh)(s["cand"], s["cand"], *jb, *ja, lo, hi,
                                                   k=k, n_cand=n_cand))
    c = torch.tensor(s["cand"])
    got = tsh.make_sharded_best(cpu_mesh(shape))(c, c, *_t(s["below"]), *_t(s["above"]), lo, hi,
                                                 k=k, n_cand=n_cand).numpy()
    np.testing.assert_array_equal(got, want)
    q = np.float32(0.5)
    x = (np.round(s["cand"] / q) * q).astype(np.float32)
    want_q = np.asarray(jsh.make_sharded_best_quantized(jmesh, False)(
        x, x, *jb, *ja, lo, hi, q, k=k, n_cand=n_cand))
    xt = torch.tensor(x)
    got_q = tsh.make_sharded_best_quantized(cpu_mesh(shape), False)(
        xt, xt, *_t(s["below"]), *_t(s["above"]), lo, hi, q, k=k, n_cand=n_cand).numpy()
    np.testing.assert_array_equal(got_q, want_q)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_batch_eval_equals_jax(shape):
    B = 24
    batch = {"x": np.arange(B, dtype=np.float32) / 3.0,
             "y": np.linspace(-1, 1, B).astype(np.float32)}
    want = np.asarray(jsh.make_sharded_batch_eval(jsh.default_mesh(shape=shape),
                                                  lambda c: c["x"] ** 2 + c["y"])(batch))
    run = tsh.make_sharded_batch_eval(cpu_mesh(shape), lambda c: c["x"] ** 2 + c["y"])
    got = run({k: torch.tensor(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if shape[0] > 1:
        with pytest.raises(ValueError, match="pad it"):
            run({k: torch.tensor(v[:B - 1]) for k, v in batch.items()})


# ---------------------------------------------------------------------
# the shard step: pair-score partials
# ---------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(seed=2, kb=3, ka=22), dict(seed=3, kb=1, ka=5), dict(seed=4, kb=33, ka=300, C=70),
], ids=["kb3", "kb1", "wide"])
def test_plain_partials_combine_to_pair_score(case):
    """The plain partials' difference is ``pair_score`` (the same
    logsumexps), and the partials of every ``sp`` split combine to it to
    f32 tolerance; the CPU wrapper runs the plain version and counts no
    launch."""
    z, params, kb = _pair_inputs(**case)
    ref = pair_score(z, params, kb)
    parts = pair_lse_partials(z, params, kb)
    assert parts.shape == (2,) + tuple(z.shape)
    torch.testing.assert_close(parts[0] - parts[1], ref, rtol=0, atol=0)
    before = pair_kernel.pair_lse_partials.launches
    torch.testing.assert_close(pair_kernel.pair_lse_partials(z, params, kb), parts,
                               rtol=0, atol=0)
    assert pair_kernel.pair_lse_partials.launches == before
    for sp in (1, 2, 3, 4, 8):
        shards, wb = tsh._region_shards(params, kb, sp)
        assert len(shards) == sp and all(s.shape[-1] == shards[0].shape[-1] for s in shards)
        combined = tsh.lse_combine([pair_lse_partials(z, s, wb) for s in shards])
        torch.testing.assert_close(combined[0] - combined[1], ref, rtol=1e-6, atol=2e-5)


def test_all_padding_region_adds_exactly_zero():
    """``sp`` larger than the below region leaves shards whose below block
    is only ``(0, 0, NEG_BIG)`` padding: their partial is near NEG_BIG and
    the combine over all shards has the same bits as over the real ones."""
    z, params, kb = _pair_inputs(5, kb=2)
    shards, wb = tsh._region_shards(params, kb, 4)
    parts = [pair_lse_partials(z, s, wb) for s in shards]
    dead = [p for p, s in zip(parts, shards) if bool((s[:, 2, :wb] == NEG_BIG).all())]
    assert len(dead) == 2 and all(bool((p[0] < -1e29).all()) for p in dead)
    with_dead = tsh.lse_combine(parts)[0]
    live = [p[0] for p in parts if not any(p is d for d in dead)]
    without = tsh.lse_combine(live)
    assert torch.equal(with_dead.view(torch.int32), without.view(torch.int32))


def test_partials_wrapper_checks_its_inputs():
    z, params, kb = _pair_inputs(6)
    with pytest.raises(ValueError, match="two non-empty regions"):
        pair_kernel.pair_lse_partials(z, params, 0)
    with pytest.raises(ValueError, match="contiguous"):
        pair_kernel.pair_lse_partials(z.t().contiguous().t(), params, kb)


# ---------------------------------------------------------------------
# DeviceMesh units (tests/test_mesh.py::TestDeviceMesh)
# ---------------------------------------------------------------------


def test_auto_uses_every_given_device():
    m = DeviceMesh.auto(devices=CPU8)
    assert m.n_devices == 8 and m.dp * m.sp == 8 and m.grid is not None
    assert (m.dp, m.sp) == (4, 2)  # the reference's heuristic
    assert m.topology() == {"backend": "cpu", "device_count": 8, "mesh": m.shape_str}
    assert m.lead_device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no"):
            DeviceMesh.auto()  # the local CUDA devices: none here


def test_single_device_is_degenerate():
    m = DeviceMesh(devices=["cpu"])
    assert m.grid is None and (m.dp, m.sp) == (1, 1)
    assert m.topology()["mesh"] == "off"
    assert resolve_mesh(m) is None and mesh_shape_str(m) == "off"
    assert resolve_mesh(DeviceMesh(["cpu"], shape=(1, 1))) is None


def test_from_spec_grammar():
    fs = partial(DeviceMesh.from_spec, devices=CPU8)
    assert fs(None) is None and fs("off") is None
    assert fs("auto").n_devices == 8
    m = fs("4x2")
    assert (m.dp, m.sp) == (4, 2) and fs("4,2") == m and hash(fs("4,2")) == hash(m)
    assert fs(m) is m and fs("2x4") != m
    assert default_mesh(devices=CPU8) == fs("auto")
    for bad, match in (("3x9", "covers"), ("banana", "bad mesh"), ("0x2", ">= 1"),
                       ("1x2", "covers 2 device")):
        with pytest.raises(ValueError, match=match):
            fs(bad)


def test_labels_and_shape_str():
    m = DeviceMesh.from_spec("4x2", devices=CPU8)
    assert m.shape_str == "4x2"
    labels = m.device_labels()
    assert labels == ["cpu:0"] * 8  # one device repeated over the slots
    assert mesh_shape_str(None) == "off" and mesh_shape_str(m) == "4x2"
    assert m.local_slots() == [(i, j) for i in range(4) for j in range(2)]
    assert all(m.slot_stream(i, j) is None for i, j in m.local_slots())  # no stream on the CPU


# ---------------------------------------------------------------------
# determinism (tests/test_mesh.py::TestMeshDeterminism)
# ---------------------------------------------------------------------


def test_degenerate_mesh_is_single_device_program_bit_for_bit():
    domain, trials = _history_trials()
    degenerate = DeviceMesh(devices=["cpu"])
    prep_none = tpe.suggest_prepare([100], domain, trials, 7, device="cpu", **AP)
    prep_deg = tpe.suggest_prepare([100], domain, trials, 7, mesh=degenerate, **AP)
    assert tpe_device.program_key(prep_none[0]) == tpe_device.program_key(prep_deg[0])
    for (_, _, st_a), (_, _, st_b) in zip(prep_none[0], prep_deg[0]):
        assert st_a == st_b and st_a.get("mesh") is None
    a = tpe.suggest([100], domain, trials, 7, device="cpu", **AP)
    for mesh in (degenerate, "off", "auto"):
        b = tpe.suggest([100], domain, trials, 7, device="cpu", mesh=mesh, **AP)
        assert a[0]["misc"]["vals"] == b[0]["misc"]["vals"]


def _fmin_vals(algo, n=16, seed=11):
    trials = T.Trials()
    T.fmin(_objective, SPACE, algo=algo, max_evals=n, trials=trials,
           rstate=np.random.default_rng(seed), show_progressbar=False, verbose=False,
           max_speculation=0)
    return [t["misc"]["vals"] for t in trials.trials]


@pytest.fixture(scope="module")
def unsharded_trajectory():
    return _fmin_vals(partial(tpe.suggest, device="cpu", **AP))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_trajectory_equals_unsharded(unsharded_trajectory, shape):
    """A 16-trial fmin through ``tpe.suggest(mesh=...)`` on an 8-slot mesh
    is trial for trial the unsharded run at the same seeds."""
    before = pair_kernel.pair_lse_partials.launches
    sharded = _fmin_vals(partial(tpe.suggest, mesh=cpu_mesh(shape), **AP))
    assert len(sharded) == len(unsharded_trajectory) == 16
    for i, (u, s) in enumerate(zip(unsharded_trajectory, sharded)):
        assert u == s, (i, u, s)
    assert pair_kernel.pair_lse_partials.launches == before  # CPU: the plain version


def test_sharded_suggest_equals_jax_sharded(monkeypatch):
    """The port's sharded suggests against the JAX package's, each on a
    2×4 mesh of 8 devices, JAX's uniforms injected into the port, every
    step from the same history (JAX's suggestion is what both record):
    each value equal to rtol 1e-5 and the choice indices equal."""
    jdom = J.Domain(lambda c: 0.0, JSPACE)
    jt = J.Trials()
    rng = np.random.default_rng(0)
    for i in range(8):
        docs = J.rand.suggest([i], jdom, jt, int(rng.integers(2 ** 31 - 1)))
        docs[0]["state"] = JOB_STATE_DONE
        docs[0]["result"] = {"status": STATUS_OK, "loss": float(rng.normal())}
        jt.insert_trial_docs(docs)
        jt.refresh()
    tt = T.trials_from_docs(copy.deepcopy(jt.trials))
    tdom = T.Domain(lambda c: 0.0, SPACE)
    monkeypatch.setattr(tpe, "_label_uniforms", jax_streams)
    jmesh = J.parallel.sharding.DeviceMesh.from_spec("2x4")
    tmesh = cpu_mesh((2, 4))
    n, close = 0, 0
    for step in range(12):
        tid, seed = 8 + step, 1000 + step
        jdocs = J.tpe.suggest([tid], jdom, jt, seed, mesh=jmesh, **AP)
        tdocs = T.tpe.suggest([tid], tdom, tt, seed, mesh=tmesh, **AP)
        assert tdocs[0]["misc"]["idxs"] == jdocs[0]["misc"]["idxs"]
        for lb, jv in jdocs[0]["misc"]["vals"].items():
            n += len(jv)
            close += sum(bool(np.isclose(t, j, rtol=1e-5, atol=0))
                         for t, j in zip(tdocs[0]["misc"]["vals"][lb], jv))
        point = {lb: v[0] for lb, v in jdocs[0]["misc"]["vals"].items() if v}
        point["c"] = ["a", "b"][int(point["c"])]
        jdocs[0]["state"] = JOB_STATE_DONE
        jdocs[0]["result"] = {"status": STATUS_OK, "loss": _objective(point)}
        tt.insert_trial_docs(copy.deepcopy(jdocs))
        jt.insert_trial_docs(jdocs)
        jt.refresh()
        tt.refresh()
    assert close == n, (close, n)


def test_mixed_family_batched_dispatch_under_mesh():
    mesh = cpu_mesh((4, 2))
    space_b = {"lr": T.hp.loguniform("lr", np.log(1e-4), np.log(1.0)), "u": T.hp.randint("u", 5)}
    da, ta = _history_trials(seed=0, n=6)
    db, tb = _history_trials(seed=1, n=9, space=space_b)
    kw = dict(mesh=mesh, **AP)
    direct_a = tpe.suggest([60], da, ta, 123, **kw)
    direct_b = tpe.suggest([90, 91], db, tb, 456, **kw)
    prep_a = tpe.suggest_prepare([60], da, ta, 123, **kw)
    prep_b = tpe.suggest_prepare([90, 91], db, tb, 456, **kw)
    assert any(st.get("mesh") == mesh for _, _, st in prep_a[0])
    res_a, res_b = tpe_device.multi_study_suggest_async([prep_a[0], prep_b[0]])
    batched_b = prep_b[1](res_b())
    batched_a = prep_a[1](res_a())
    for direct, batched in ((direct_a, batched_a), (direct_b, batched_b)):
        assert [d["misc"]["vals"] for d in direct] == [b["misc"]["vals"] for b in batched]


def test_fusing_two_different_meshes_is_refused():
    da, ta = _history_trials(seed=0, n=6)
    db, tb = _history_trials(seed=1, n=9)
    prep_a = tpe.suggest_prepare([60], da, ta, 123, mesh=cpu_mesh((4, 2)), **AP)
    prep_b = tpe.suggest_prepare([90], db, tb, 456, mesh=cpu_mesh((2, 4)), **AP)
    with pytest.raises(ValueError, match="different"):
        for r in tpe_device.multi_study_suggest_async([prep_a[0], prep_b[0]]):
            r()


def test_reset_device_state_clears_mesh_state():
    mesh = cpu_mesh((2, 4))
    domain, trials = _history_trials(seed=3)
    prep = tpe.suggest_prepare([50], domain, trials, 5, mesh=mesh, **AP)
    tpe_device.multi_family_suggest_async(prep[0])()
    assert tpe_device.is_warm(prep[0])
    dh = tpe_device.device_history_for(trials, domain.space, None, mesh=mesh)
    assert dh._n_synced > 0 and dh.mesh == mesh and dh.device == torch.device("cpu")
    tpe_device.reset_device_state()
    assert not tpe_device.is_warm(prep[0]) and not tpe_device._cache
    docs = tpe.suggest([51], domain, trials, 6, mesh=mesh, **AP)
    assert docs and -5 <= docs[0]["misc"]["vals"]["x"][0] <= 5


def test_mesh_device_must_be_the_lead_slot():
    domain, trials = _history_trials(seed=3)
    mesh = cpu_mesh((2, 4))
    with pytest.raises(ValueError, match="lead slot"):
        tpe.suggest([60], domain, trials, 1, device="cuda", mesh=mesh, **AP)
    with pytest.raises(ValueError, match="covers 4"):
        tpe.suggest([60], domain, trials, 1, device="cpu", mesh="2x2", **AP)


def test_atpe_and_torch_trials_take_a_mesh():
    """``atpe.suggest(mesh=)`` equals its unsharded suggest at the same
    seed; ``TorchTrials(device_fn=..., mesh=2×1)``'s device plane (a batch
    padded to the ``dp`` extent) gives the unsharded plane's losses."""
    domain, trials = _history_trials(seed=2, n=24)
    a = T.atpe.suggest([100], domain, trials, 3, device="cpu")
    b = T.atpe.suggest([100], domain, trials, 3, mesh=cpu_mesh((2, 4)))
    assert a[0]["misc"]["vals"] == b[0]["misc"]["vals"]

    space = {"x": T.hp.uniform("x", -2, 2), "y": T.hp.uniform("y", -1, 1)}

    def run(mesh):
        tt = T.TorchTrials(parallelism=3, device_fn=lambda c: c["x"] ** 2 + c["y"],
                           device="cpu", mesh=mesh)
        T.fmin(lambda c: 0.0, space, algo=partial(T.rand.suggest, device="cpu"),
               max_evals=9, trials=tt, rstate=np.random.default_rng(5),
               show_progressbar=False)
        return tt

    plain, sharded = run(None), run(DeviceMesh(["cpu"] * 2, (2, 1)))
    assert sharded.device_batches > 0 and sharded.host_trials == 0
    by_vals = {repr(t["misc"]["vals"]): t["result"]["loss"] for t in plain.trials}
    for t in sharded.trials:
        c = {k: v[0] for k, v in t["misc"]["vals"].items()}
        assert t["result"]["loss"] == pytest.approx(c["x"] ** 2 + c["y"], rel=1e-6)
        if repr(t["misc"]["vals"]) in by_vals:
            assert t["result"]["loss"] == by_vals[repr(t["misc"]["vals"])]


# ---------------------------------------------------------------------
# the service (tests/test_mesh.py::TestServiceMesh)
# ---------------------------------------------------------------------


def _service(**kw):
    from hyperopt_tpu_torch.service.core import OptimizationService

    return OptimizationService(root=None, device="cpu", warmup=False, slo_enabled=False, **kw)


def test_mesh_service_reproduces_serial_fmin():
    trials = T.Trials()
    T.fmin(_objective, SPACE, algo=partial(tpe.suggest, device="cpu", **AP), max_evals=10,
           trials=trials, rstate=np.random.default_rng(42), show_progressbar=False,
           verbose=False, max_speculation=0)
    ref = [{k: v[0] for k, v in t["misc"]["vals"].items() if len(v)} for t in trials.trials]
    mesh = cpu_mesh((2, 4))
    svc = _service(batch_window=0.001, mesh=mesh)
    try:
        assert svc.mesh == mesh and svc.mesh_label == "2x4"
        assert svc.scheduler.mesh_label == "2x4"
        svc.create_study("s", SPACE, seed=42, algo="tpe", algo_params=AP)
        assert svc.registry.get("s").mesh == mesh
        got = []
        for _ in range(10):
            (t,) = svc.suggest("s", n=1)
            got.append(t)
            svc.report("s", t["tid"], loss=_objective(T.space_eval(SPACE, t["vals"])))
        status = svc.service_status()
    finally:
        svc.close()
    for i, (rv, g) in enumerate(zip(ref, got)):
        assert rv.keys() == g["vals"].keys(), (i, rv, g)
        for k in rv:
            assert np.isclose(rv[k], g["vals"][k]), (i, k, rv, g)
    assert status["mesh"] == {"label": "2x4", "topology": mesh.topology()}
    assert status["mesh"]["topology"]["device_count"] == 8
    # eight slots on one device: the per-device split names it once
    assert list(status["device"]["per_device"]) == ["cpu:0"]
    assert "pair_lse_partials" in status["kernel_launches"]


def test_per_study_mesh_override_validated_at_create():
    mesh = cpu_mesh((4, 2))
    svc = _service(mesh=mesh)
    try:
        svc.create_study("opt-out", SPACE, seed=1, algo="tpe", algo_params={"mesh": "off", **AP})
        svc.create_study("same", SPACE, seed=1, algo="tpe", algo_params={"mesh": "4x2", **AP})
        assert svc.registry.get("opt-out").mesh is None
        assert svc.registry.get("same").mesh == mesh
        with pytest.raises(ValueError, match="--mesh"):
            svc.create_study("other", SPACE, seed=1, algo="tpe",
                             algo_params={"mesh": "2x4", **AP})
        assert "other" not in [s.study_id for s in svc.registry.studies()]
        # both kinds of study share one batched dispatch
        for sid in ("opt-out", "same"):
            for _ in range(5):
                (t,) = svc.suggest(sid, n=1)
                svc.report(sid, t["tid"], loss=_objective(T.space_eval(SPACE, t["vals"])))
    finally:
        svc.close()


def test_mesh_off_is_default_and_unchanged():
    svc = _service()
    try:
        assert svc.mesh is None and svc.mesh_label == "off"
        assert svc.service_status()["mesh"]["topology"] is None
    finally:
        svc.close()


def test_cli_mesh_flag(tmp_path):
    """``--mesh`` takes ``auto``/``off``/``DPxSP``; a shape that does not
    cover the local devices exits 2 naming it."""
    from hyperopt_tpu_torch.service.__main__ import main

    out = subprocess.run(
        [sys.executable, "-m", "hyperopt_tpu_torch.service", "--device", "cpu", "--mesh", "2x2",
         "--port", "0"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "covers 4 device" in out.stderr, out.stderr[-2000:]
    assert main is not None


# ---------------------------------------------------------------------
# the compile ledger (tests/test_mesh.py::TestLedgerTopology)
# ---------------------------------------------------------------------


def test_fingerprint_carries_topology():
    try:
        compile_ledger.set_topology(None, device="cpu")
        fp_off = compile_ledger.fingerprint()
        assert fp_off["topology"] == {"backend": "cpu", "device_count": 1, "mesh": "off"}
        compile_ledger.set_topology(cpu_mesh((4, 2)))
        fp_mesh = compile_ledger.fingerprint()
        assert fp_mesh["topology"] == {"backend": "cpu", "device_count": 8, "mesh": "4x2"}
        assert fp_mesh != fp_off
    finally:
        compile_ledger.set_topology(None)


def test_ledger_refuses_cross_topology_replay(tmp_path):
    domain, trials = _history_trials(seed=4)
    prep = tpe.suggest_prepare([70], domain, trials, 9, device="cpu", **AP)
    sig = tpe_device._multi_sig(prep[0])
    shapes = tpe_device.args_shapes([a for _, a, _ in prep[0]])
    ledger = compile_ledger.CompileLedger(str(tmp_path / "ledger.jsonl"))
    mesh = cpu_mesh((4, 2))
    try:
        compile_ledger.set_topology(None, device="cpu")
        ledger.record_compile(sig, shapes, duration_s=1.0)
        assert len(ledger.entries(current_fingerprint=compile_ledger.fingerprint())) == 1
        compile_ledger.set_topology(mesh)
        fp_mesh = compile_ledger.fingerprint()
        assert ledger.entries(current_fingerprint=fp_mesh) == []
        prep_m = tpe.suggest_prepare([71], domain, trials, 9, mesh=mesh, **AP)
        rec_m = ledger.record_compile(tpe_device._multi_sig(prep_m[0]),
                                      tpe_device.args_shapes([a for _, a, _ in prep_m[0]]),
                                      duration_s=1.0)
        assert len(ledger.entries(current_fingerprint=fp_mesh)) == 1
        compile_ledger.set_topology(None, device="cpu")
        off_keys = {r["replay_key"] for r in
                    ledger.entries(current_fingerprint=compile_ledger.fingerprint())}
        assert rec_m["replay_key"] not in off_keys and len(off_keys) == 1
    finally:
        compile_ledger.set_topology(None)


def test_mesh_record_replays_onto_live_mesh(tmp_path):
    mesh = cpu_mesh((2, 4))
    domain, trials = _history_trials(seed=5)
    prep = tpe.suggest_prepare([80], domain, trials, 13, mesh=mesh, **AP)
    sig = tpe_device._multi_sig(prep[0])
    shapes = tpe_device.args_shapes([a for _, a, _ in prep[0]])
    rec = compile_ledger.CompileLedger(str(tmp_path / "l.jsonl")).record_compile(
        sig, shapes, duration_s=1.0)
    (reloaded,) = compile_ledger.CompileLedger(str(tmp_path / "l.jsonl")).entries()
    assert reloaded["replay_key"] == rec["replay_key"]
    assert any(dict(st).get("mesh") == {compile_ledger.MESH_TOKEN: "2x4"}
               for _, st in reloaded["sig"])
    assert compile_ledger.requests_from_record(reloaded, device="cpu") is None
    replay = compile_ledger.requests_from_record(reloaded, mesh=mesh)
    assert tpe_device.program_key(replay) == tpe_device.program_key(prep[0])
    assert compile_ledger.requests_from_record(reloaded, mesh=cpu_mesh((4, 2))) is None
    # the replayed request list dispatches on the mesh
    tpe_device.multi_family_suggest_async(replay)()


# ---------------------------------------------------------------------
# per-device telemetry (tests/test_mesh.py::TestPerDeviceTelemetry)
# ---------------------------------------------------------------------


def test_mesh_dispatch_attributes_each_device_once():
    from hyperopt_tpu_torch import profiling
    from hyperopt_tpu_torch.observability import DeviceStats, render_prometheus

    mesh = cpu_mesh((2, 4))
    domain, trials = _history_trials(seed=6)
    stats = DeviceStats()
    with profiling.DeviceProfiler(stats=stats):
        tpe.suggest([40], domain, trials, 2, mesh=mesh, **AP)
        tpe.suggest([41], domain, trials, 3, device="cpu", **AP)
    per_dev = stats.summary()["per_device"]
    assert list(per_dev) == ["cpu:0"] and per_dev["cpu:0"]["n_dispatches"] == 2
    text = render_prometheus(device=stats)
    assert 'hyperopt_device_duty_cycle{device="cpu:0"}' in text
    # a record that names a device twice counts it once
    stats.record_dispatch({"device_s": 0.5, "devices": ["cuda:0", "cuda:1", "cuda:0"]})
    per_dev = stats.summary()["per_device"]
    assert per_dev["cuda:0"]["n_dispatches"] == per_dev["cuda:1"]["n_dispatches"] == 1


def test_mesh_peaks_scale_with_distinct_devices():
    """A dispatch over a mesh of distinct devices records each (the lead
    first) and its ceilings are their sum; slots sharing one device are
    that device once, at its own ceiling."""
    from hyperopt_tpu_torch import profiling
    from hyperopt_tpu_torch.observability import DeviceStats

    domain, trials = _history_trials(seed=7)
    prep = tpe.suggest_prepare([45], domain, trials, 2, mesh=cpu_mesh((2, 4)), **AP)
    assert profiling.dispatch_devices(prep[0]) == ["cpu:0"]
    assert profiling.dispatch_mesh(prep[0]) == cpu_mesh((2, 4))
    two = DeviceMesh(["cpu", "cuda:1"], shape=(2, 1))
    requests = [(kind, args, dict(st, mesh=two) if "mesh" in st else st)
                for kind, args, st in prep[0]]
    assert profiling.dispatch_devices(requests) == ["cpu:0", "cuda:1"]
    assert "mesh2x1" in profiling.signature_key(requests)
    stats = DeviceStats()
    prof = profiling.DeviceProfiler(stats=stats)
    single = profiling.platform_peaks("cpu")
    prof._observe(requests)({"device_s": 0.01, "n_requests": len(requests)})
    rec = stats.last_record()
    assert rec["devices"] == ["cpu:0", "cuda:1"]
    if rec["roofline_pct_bw"] is not None:
        expect = 100.0 * rec["achieved_GBps"] / (single["peak_hbm_GBps"] * 2)
        assert rec["roofline_pct_bw"] == pytest.approx(expect, rel=1e-6)


# ---------------------------------------------------------------------
# two processes, sp across the process boundary
# ---------------------------------------------------------------------


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_shard_sp_across_gloo():
    """``tests/test_parallel.py::TestMultiProcessDistributed`` on the port:
    2 processes × 2 CPU slots form a 2×2 mesh over gloo, transposed so that
    every ``sp`` combine crosses the process boundary (and the production
    layout, where ``dp`` does); both check their rows against the
    single-device scores.  Each process has 240 s; on a timeout both are
    killed and reaped and the test fails with their output."""
    outs, procs = _run_ranks("dist", _free_port())
    for r, p in enumerate(procs):
        assert p.returncode == 0 and f"DIST_SCORE_OK rank={r}" in outs[r], _texts(outs)


def test_two_processes_reinitialize_and_score():
    """The process groups a mesh made belong to the world they were made
    in: after ``destroy_process_group`` and a new ``initialize``, an equal
    mesh scores through groups of the new world, never a cached group of
    the destroyed one."""
    outs, procs = _run_ranks("redist", _free_port(), _free_port())
    for r, p in enumerate(procs):
        assert p.returncode == 0 and f"REINIT_OK rank={r}" in outs[r], _texts(outs)


def _texts(outs):
    return "\n".join(f"--- rank {r} ---\n{outs[r]}" for r in sorted(outs))


def _run_ranks(mode, *ports):
    """Both ranks of the helper, each with 240 s; on a timeout both are
    killed and reaped and the test fails with their output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               *map(str, ports)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs, timed_out = {}, False
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=240)[0]
    except subprocess.TimeoutExpired:
        timed_out = True
        for p in procs:
            p.kill()
        for r, p in enumerate(procs):
            if r not in outs:
                outs[r] = p.communicate()[0]
    assert not timed_out, "a rank timed out:\n" + _texts(outs)
    return outs, procs


def test_distributed_is_a_no_op_for_one_process():
    from hyperopt_tpu_torch.parallel import distributed

    assert distributed.initialize() is False
    assert distributed.is_coordinator()
    m = distributed.global_mesh(shape=(1, 2), local=["cpu", "cpu"])
    assert m.ranks == (0, 0) and m.row_group(0) is None and m.all_group() is None
    assert jax.process_count() == 1  # the JAX side is one process too
