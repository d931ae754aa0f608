"""The port's ``.orbax`` checkpoints: ``tests/test_checkpoint.py``'s cases
against ``hyperopt_tpu_torch.checkpoint``, both directions of interop with
orbax (the JAX package's ``TrialsCheckpointer`` restores a directory the
port wrote, and the port restores one orbax wrote), and ``fmin``'s resume
from a checkpoint at the point an uninterrupted run reaches."""

import glob
import os
import pickle
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
from hyperopt_tpu.checkpoint import TrialsCheckpointer as JaxCheckpointer
import hyperopt_tpu_torch as T
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_NEW
from hyperopt_tpu_torch.checkpoint import (
    TrialsCheckpointer,
    atomic_pickle_dump,
    is_orbax_path,
)

RAND = partial(T.rand.suggest, device="cpu")
TPE = partial(T.tpe.suggest, device="cpu")


def _space(hp=T.hp):
    return {"x": hp.uniform("x", -5, 5)}


def _loss(d):
    return (d["x"] - 3) ** 2


def _run(trials, n, algo=RAND, seed=0, **kw):
    T.fmin(_loss, _space(), algo=algo, max_evals=n, trials=trials,
           rstate=np.random.default_rng(seed), show_progressbar=False,
           verbose=False, **kw)
    return trials


def _corrupt_step(directory, step):
    """Tear every file of one step (a crash mid-write, a truncated
    filesystem)."""
    files = [p for p in glob.glob(os.path.join(directory, str(step), "**"), recursive=True)
             if os.path.isfile(p)]
    assert files, f"no files in step {step} of {directory}"
    for p in files:
        with open(p, "wb") as f:
            f.write(b"\x00torn checkpoint\x00")


def _docs(trials):
    return [(d["tid"], d["state"], d["misc"]["vals"], d["result"], d["book_time"])
            for d in trials.trials]


class TestCheckpointer:
    def test_is_orbax_path(self):
        assert is_orbax_path("run.orbax")
        assert not is_orbax_path("run.pkl")
        assert not is_orbax_path("")

    def test_roundtrip_preserves_docs(self, tmp_path):
        trials = _run(T.Trials(), 12)
        ckpt = TrialsCheckpointer(str(tmp_path / "t.orbax"))
        assert ckpt.save(trials)
        restored = ckpt.restore()
        assert len(restored.trials) == 12
        for a, b in zip(trials.trials, restored.trials):
            assert a["tid"] == b["tid"]
            assert a["result"]["loss"] == pytest.approx(b["result"]["loss"])
            assert a["book_time"] == b["book_time"]
        assert restored.argmin == trials.argmin

    def test_same_step_is_noop(self, tmp_path):
        trials = _run(T.Trials(), 5)
        ckpt = TrialsCheckpointer(str(tmp_path / "t.orbax"))
        assert ckpt.save(trials) is True
        assert ckpt.save(trials) is False  # no new trials -> no new step

    def test_retention(self, tmp_path):
        ckpt = TrialsCheckpointer(str(tmp_path / "t.orbax"), max_to_keep=2)
        trials = T.Trials()
        for n in (4, 8, 12):
            _run(trials, n)
            ckpt.save(trials)
        assert ckpt.steps() == [2, 3]  # oldest step retired
        assert sorted(os.listdir(tmp_path / "t.orbax")) == ["2", "3"]  # no temporaries

    def test_in_place_result_mutation_triggers_save(self, tmp_path):
        """Async backends fill results into EXISTING docs (len unchanged);
        the change detector must still persist them."""
        trials = _run(T.Trials(), 6)
        ckpt = TrialsCheckpointer(str(tmp_path / "t.orbax"))
        doc = trials.trials[-1]
        doc["state"] = JOB_STATE_NEW
        saved_result = doc["result"]
        doc["result"] = {}
        trials.refresh()
        assert ckpt.save(trials) is True
        doc["state"] = JOB_STATE_DONE
        doc["result"] = saved_result
        trials.refresh()
        assert ckpt.save(trials) is True  # would be lost by a len check
        restored = ckpt.restore()
        assert restored.trials[-1]["result"]["loss"] == pytest.approx(saved_result["loss"])

    def test_restore_into_preserves_subclass(self, tmp_path):
        trials = _run(T.Trials(), 5)
        ckpt = TrialsCheckpointer(str(tmp_path / "t.orbax"))
        ckpt.save(trials)

        class MyTrials(T.Trials):
            pass

        mine = MyTrials()
        out = ckpt.restore(into=mine)
        assert out is mine and isinstance(out, MyTrials) and len(out.trials) == 5

    def test_reopened_directory_continues_its_steps(self, tmp_path):
        path = str(tmp_path / "t.orbax")
        trials = _run(T.Trials(), 4)
        TrialsCheckpointer(path).save(trials)
        _run(trials, 6)
        again = TrialsCheckpointer(path)
        assert again.save(trials) and again.steps() == [1, 2]
        assert TrialsCheckpointer(str(tmp_path / "empty.orbax")).restore() is None


class TestRestoreHardening:
    def test_corrupted_latest_step_falls_back(self, tmp_path):
        path = str(tmp_path / "t.orbax")
        ckpt = TrialsCheckpointer(path)
        trials = T.Trials()
        for n in (4, 9):
            _run(trials, n)
            ckpt.save(trials)
        steps = TrialsCheckpointer(path).steps()
        assert len(steps) == 2
        _corrupt_step(path, steps[-1])
        restored = TrialsCheckpointer(path).restore()
        assert restored is not None and len(restored.trials) == 4

    def test_truncated_payload_falls_back(self, tmp_path):
        path = str(tmp_path / "t.orbax")
        ckpt = TrialsCheckpointer(path)
        trials = T.Trials()
        for n in (3, 5):
            _run(trials, n)
            ckpt.save(trials)
        payload = os.path.join(path, "2", "default", "metadata")
        with open(payload, "r+b") as f:
            f.truncate(os.path.getsize(payload) // 2)
        assert len(TrialsCheckpointer(path).restore().trials) == 3

    def test_explicit_step_request_still_raises(self, tmp_path):
        path = str(tmp_path / "t.orbax")
        ckpt = TrialsCheckpointer(path)
        ckpt.save(_run(T.Trials(), 4))
        step = TrialsCheckpointer(path).steps()[-1]
        _corrupt_step(path, step)
        with pytest.raises(ValueError):
            TrialsCheckpointer(path).restore(step=step)

    def test_every_step_torn_raises(self, tmp_path):
        path = str(tmp_path / "t.orbax")
        ckpt = TrialsCheckpointer(path)
        ckpt.save(_run(T.Trials(), 4))
        _corrupt_step(path, 1)
        with pytest.raises(ValueError):
            TrialsCheckpointer(path).restore()

    def test_atomic_pickle_dump_is_loadable_and_replaces(self, tmp_path):
        path = str(tmp_path / "trials.pkl")
        atomic_pickle_dump({"a": 1}, path)
        with open(path, "rb") as f:
            assert pickle.load(f) == {"a": 1}
        atomic_pickle_dump({"b": 2}, path)
        with open(path, "rb") as f:
            assert pickle.load(f) == {"b": 2}
        assert sorted(os.listdir(tmp_path)) == ["trials.pkl"]


class TestOrbaxInterop:
    """One layout: each package restores the other's directory."""

    def test_jax_package_restores_what_the_port_wrote(self, tmp_path):
        path = str(tmp_path / "port.orbax")
        trials = _run(T.Trials(), 9)
        ckpt = TrialsCheckpointer(path, max_to_keep=2)
        ckpt.save(trials)
        _run(trials, 11)
        ckpt.save(trials)
        jax_ckpt = JaxCheckpointer(path)
        try:
            assert jax_ckpt.steps() == [1, 2]
            restored = jax_ckpt.restore()
            assert _docs(restored) == _docs(trials)
            assert len(jax_ckpt.restore(step=1).trials) == 9
        finally:
            jax_ckpt.close()

    def test_port_restores_what_orbax_wrote(self, tmp_path):
        path = str(tmp_path / "jax.orbax")
        jtrials = J.Trials()
        J.fmin(_loss, _space(J.hp), algo=J.rand.suggest, max_evals=7, trials=jtrials,
               rstate=np.random.default_rng(3), show_progressbar=False, verbose=False)
        jax_ckpt = JaxCheckpointer(path)
        try:
            jax_ckpt.save(jtrials)
        finally:
            jax_ckpt.close()
        restored = TrialsCheckpointer(path).restore()
        assert _docs(restored) == _docs(jtrials)
        # the port continues the directory's step numbering
        ckpt = TrialsCheckpointer(path)
        _run(restored, 8)
        assert ckpt.save(restored) and ckpt.steps() == [1, 2]

    def test_payload_bytes_equal_orbax_s(self, tmp_path):
        """The step payload is byte for byte what orbax writes for the
        same docs."""
        trials = _run(T.Trials(), 5)
        TrialsCheckpointer(str(tmp_path / "p.orbax")).save(trials)
        jax_ckpt = JaxCheckpointer(str(tmp_path / "j.orbax"))
        try:
            jax_ckpt.save(trials)
        finally:
            jax_ckpt.close()
        read = [open(os.path.join(tmp_path, d, "1", "default", "metadata"), "rb").read()
                for d in ("p.orbax", "j.orbax")]
        assert read[0] == read[1]
        assert sorted(os.listdir(tmp_path / "p.orbax" / "1")) == \
            sorted(os.listdir(tmp_path / "j.orbax" / "1"))


class TestFminIntegration:
    def test_fmin_saves_and_resumes(self, tmp_path):
        path = str(tmp_path / "run.orbax")
        T.fmin(_loss, _space(), algo=TPE, max_evals=8, trials_save_file=path,
               rstate=np.random.default_rng(1), show_progressbar=False, verbose=False)
        assert len(TrialsCheckpointer(path).restore().trials) == 8
        T.fmin(_loss, _space(), algo=TPE, max_evals=15, trials_save_file=path,
               rstate=np.random.default_rng(1), show_progressbar=False, verbose=False)
        assert len(TrialsCheckpointer(path).restore().trials) == 15

    def test_resume_continues_an_uninterrupted_run(self, tmp_path):
        """8 trials saved, resumed in a fresh ``Trials`` to 24 with the
        same ``rstate`` stream: trial for trial the uninterrupted run (TPE
        past its 20 startup trials)."""
        path = str(tmp_path / "run.orbax")
        rstate = np.random.default_rng(5)
        T.fmin(_loss, _space(), algo=TPE, max_evals=8, trials=T.Trials(),
               trials_save_file=path, rstate=rstate, show_progressbar=False)
        resumed = T.Trials()
        T.fmin(_loss, _space(), algo=TPE, max_evals=24, trials=resumed,
               trials_save_file=path, rstate=rstate, show_progressbar=False)
        whole = _run(T.Trials(), 24, algo=TPE, seed=5)
        assert [d["misc"]["vals"] for d in resumed.trials] == \
            [d["misc"]["vals"] for d in whole.trials]
        assert resumed.losses() == whole.losses()
        # one step per completed trial of the serial loop, 3 retained
        assert TrialsCheckpointer(path).steps() == [22, 23, 24]

    def test_fmin_iter_built_directly_owns_its_checkpointer(self, tmp_path):
        from hyperopt_tpu_torch.fmin import FMinIter

        path = str(tmp_path / "it.orbax")
        trials = T.Trials()
        it = FMinIter(RAND, T.Domain(_loss, _space()), trials, max_evals=3,
                      rstate=np.random.default_rng(0), trials_save_file=path,
                      show_progressbar=False)
        it.exhaust()
        assert len(TrialsCheckpointer(path).restore().trials) == 3
