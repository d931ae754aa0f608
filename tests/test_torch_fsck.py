"""The port's queue fsck (``hyperopt_tpu_torch.resilience.fsck``) against
the JAX package's: every queue case of ``tests/test_fsck.py`` (FS401-FS404,
FS406, FS408, the segmented store's FS410-FS412, a real SIGKILL inside a
segment append and inside a compaction, the CLI), plus FS405/FS407 and
FS401's journal restore over hand-written service attachments.  Each
damage is made identically in two copies of one queue; the JAX package's
fsck runs on one copy and the port's on the other, and the dry-run
findings, the repairs and the repaired trees are equal — on queues either
package wrote.  The service-root checks (``fsck_service_root`` and the
replica plane's FS409) are held against the JAX package's in
``tests/test_torch_service.py`` and ``tests/test_torch_replicas.py``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from hyperopt_tpu import journal_io as j_journal_io
from hyperopt_tpu.parallel import file_trials as jft
from hyperopt_tpu.resilience import fsck as jfsck
from hyperopt_tpu_torch import journal_io as t_journal_io
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_NEW, JOB_STATE_RUNNING
from hyperopt_tpu_torch.parallel import file_trials as tft
from hyperopt_tpu_torch.resilience import fsck as tfsck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = {"jax": (jft, j_journal_io), "torch": (tft, t_journal_io)}


def _mk_queue(ft, qdir, n_docs=3, backend="doc"):
    trials = ft.FileTrials(qdir, backend=backend)
    docs = []
    for tid in trials.new_trial_ids(n_docs):
        doc = {
            "tid": tid, "state": JOB_STATE_NEW, "spec": None,
            "result": {"status": "new"},
            "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]},
                     "vals": {"x": [0.5]}, "workdir": None},
            "exp_key": None, "owner": None, "version": 0,
            "book_time": None, "refresh_time": None,
        }
        trials.insert_trial_docs([doc])
        docs.append(doc)
    return trials, docs


def _truncate(path, keep=None, cut=None):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(keep if keep is not None else (size - cut if cut else size // 2))


def _manifest_active(qdir):
    raw = open(os.path.join(qdir, "segments", "MANIFEST.json"), "rb").read()
    return json.loads(raw.split(b"\n#crc32:")[0])["active"]


# Each damage: (backend, seal, function(qdir, trials, docs, ft, journal_io))
def d_fs401(q, t, docs, ft, jio):
    _truncate(t.jobs.trial_path(docs[0]["tid"]))


def d_fs402(q, t, docs, ft, jio):
    t.jobs.grant_lease(docs[0]["tid"], "nobody")  # doc is NEW
    t.jobs.grant_lease(999, "ghost")  # no doc at all


def d_fs403(q, t, docs, ft, jio):
    for tid, owner in ((docs[0]["tid"], "dead-worker"), (777, "ghost")):
        with open(t.jobs.lock_path(tid), "w") as f:
            f.write(owner)


def d_fs403_running_keeps_lock(q, t, docs, ft, jio):
    doc = dict(docs[0], state=JOB_STATE_RUNNING)
    t.jobs.write(doc)
    with open(t.jobs.lock_path(doc["tid"]), "w") as f:
        f.write("live-worker")
    t.jobs.grant_lease(doc["tid"], "live-worker")


def d_fs404(q, t, docs, ft, jio):
    shutil.copyfile(t.jobs.trial_path(docs[0]["tid"]), t.jobs.trial_path(42))


def d_fs406(q, t, docs, ft, jio):
    with open(os.path.join(q, "trials", "000000000000.json.tmp.123.456"), "w") as f:
        f.write("{partial")


def d_fs408(q, t, docs, ft, jio):
    for name in ("ids.counter.lock", "ids.counter"):
        open(os.path.join(q, name), "w").close()


def _journal(q, entries, ft, jio):
    path = os.path.join(q, "attachments", tfsck.RESPONSE_JOURNAL_ATTACHMENT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jio.append_records(path, entries, default=ft._json_default)
    return path


def d_fs405_stale_seed_cursor(q, t, docs, ft, jio):
    for i, doc in enumerate(docs):
        t.jobs.write(dict(doc, misc=dict(doc["misc"], service_draw=i + 1)))
    with open(os.path.join(q, "attachments", tfsck.SEED_CURSOR_ATTACHMENT), "w") as f:
        f.write("0")


def d_fs407_torn_journal_tail(q, t, docs, ft, jio):
    entries = [{"seq": i + 1, "key": f"k{i}", "kind": "report", "tid": d["tid"],
                "result": {"status": "ok", "loss": float(i)}} for i, d in enumerate(docs)]
    _truncate(_journal(q, entries, ft, jio), cut=7)


def d_fs401_restore_from_journal(q, t, docs, ft, jio):
    """A torn doc the journal holds (a suggest entry with the doc, and a
    report with its result): the repair restores it DONE."""
    _journal(q, [
        {"seq": 1, "key": "k0", "kind": "suggest", "draw_index": 1, "docs": [docs[0]]},
        {"seq": 2, "key": "r0", "kind": "report", "tid": docs[0]["tid"],
         "result": {"status": "ok", "loss": 0.0}},
    ], ft, jio)
    with open(os.path.join(q, "attachments", tfsck.SEED_CURSOR_ATTACHMENT), "w") as f:
        f.write("1")  # the cursor is current: only the doc is damaged
    _truncate(t.jobs.trial_path(docs[0]["tid"]))


def d_fs410_torn_active_tail(q, t, docs, ft, jio):
    _truncate(os.path.join(q, "segments", _manifest_active(q)), cut=9)


def d_fs410_sealed_garbled(q, t, docs, ft, jio):
    (entry,) = t.jobs.segments.sealed_entries()
    path = os.path.join(q, "segments", entry["name"])
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff\xff\xff\xff")


def d_fs411_missing_manifest(q, t, docs, ft, jio):
    os.unlink(os.path.join(q, "segments", "MANIFEST.json"))


def d_fs411_missing_sealed(q, t, docs, ft, jio):
    (entry,) = t.jobs.segments.sealed_entries()
    os.unlink(os.path.join(q, "segments", entry["name"]))


def d_fs411_short_sealed(q, t, docs, ft, jio):
    (entry,) = t.jobs.segments.sealed_entries()
    _truncate(os.path.join(q, "segments", entry["name"]), cut=9)


def d_fs412_orphan(q, t, docs, ft, jio):
    with open(os.path.join(q, "segments", "seg-00000042.log"), "wb") as f:
        f.write(b"\nretired data the dead compactor left behind")


def d_fs412_orphan_with_acked_records(q, t, docs, ft, jio):
    jio.append_records(os.path.join(q, "segments", "seg-00000042.log"),
                       [{"tid": 77, "state": JOB_STATE_NEW, "misc": {"tid": 77}}],
                       default=ft._json_default, fsync_kind="segment")


def d_fs412_stale_orphan_copy(q, t, docs, ft, jio):
    t.jobs.segments.append(dict(docs[0], state=JOB_STATE_DONE))
    jio.append_records(os.path.join(q, "segments", "seg-00000042.log"), [docs[0]],
                       default=ft._json_default, fsync_kind="segment")


DAMAGES = {
    # name: (backend, seal, damage, rules found by the dry run)
    "fs401_torn_doc": ("doc", False, d_fs401, {"FS401": 1}),
    "fs402_orphan_lease": ("doc", False, d_fs402, {"FS402": 2}),
    "fs403_orphan_lock": ("doc", False, d_fs403, {"FS403": 2}),
    "fs403_running_doc_keeps_lock": ("doc", False, d_fs403_running_keeps_lock, {}),
    "fs404_tid_filename_mismatch": ("doc", False, d_fs404, {"FS404": 1}),
    "fs405_stale_seed_cursor": ("doc", False, d_fs405_stale_seed_cursor, {"FS405": 1}),
    "fs406_tmp_droppings": ("doc", False, d_fs406, {"FS406": 1}),
    "fs407_torn_journal_tail": ("doc", False, d_fs407_torn_journal_tail, {"FS407": 1}),
    "fs408_counter": ("doc", False, d_fs408, {"FS408": 2}),
    "fs401_restore_from_journal": ("doc", False, d_fs401_restore_from_journal, {"FS401": 1}),
    "fs410_torn_active_tail": ("segment", False, d_fs410_torn_active_tail, {"FS410": 1}),
    "fs410_sealed_garbled": ("segment", True, d_fs410_sealed_garbled, None),
    "fs411_missing_manifest": ("segment", True, d_fs411_missing_manifest, None),
    "fs411_missing_sealed": ("segment", True, d_fs411_missing_sealed, None),
    "fs411_short_sealed": ("segment", True, d_fs411_short_sealed, None),
    "fs412_orphan": ("segment", False, d_fs412_orphan, {"FS412": 1}),
    "fs412_orphan_with_acked_records": ("segment", False, d_fs412_orphan_with_acked_records,
                                        {"FS412": 1}),
    "fs412_stale_orphan_copy": ("segment", False, d_fs412_stale_orphan_copy, {"FS412": 1}),
}


def _rel(report, root):
    return [(f.rule, os.path.relpath(f.path, root), f.detail, f.repaired, f.action)
            for f in report.findings]


def _tree(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _replayed(ft, qdir):
    trials = ft.FileTrials(qdir)
    trials.refresh()
    return sorted((d["tid"], d["state"]) for d in trials._dynamic_trials)


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("name", sorted(DAMAGES))
def test_damage_found_and_repaired_as_the_reference_does(tmp_path, writer, name):
    backend, seal, damage, expected = DAMAGES[name]
    ft, jio = WRITERS[writer]
    base = str(tmp_path / "base")
    trials, docs = _mk_queue(ft, base, backend=backend)
    if seal:
        trials.jobs.segments.seal_active()
    damage(base, trials, docs, ft, jio)
    qj, qt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, qj)
    shutil.copytree(base, qt)
    before = _tree(qt)
    dry_j, dry_t = jfsck.fsck_queue(qj), tfsck.fsck_queue(qt)
    assert _rel(dry_t, qt) == _rel(dry_j, qj)
    assert _tree(qt) == before  # a dry run touches nothing
    if expected is not None:
        assert dry_t.by_rule() == expected
    assert dry_t.clean == (not dry_t.findings)
    rep_j, rep_t = jfsck.fsck_queue(qj, repair=True), tfsck.fsck_queue(qt, repair=True)
    assert _rel(rep_t, qt) == _rel(rep_j, qj)
    assert rep_t.clean and rep_t.summary()["by_rule"] == rep_j.summary()["by_rule"]
    assert _tree(qt) == _tree(qj)
    assert tfsck.fsck_queue(qt).clean and jfsck.fsck_queue(qj).clean
    # each package reads the repaired queue as the other does
    assert _replayed(tft, qt) == _replayed(jft, qj)
    if name == "fs401_restore_from_journal":
        doc = tft._read_doc(tft.FileJobs(qt).trial_path(docs[0]["tid"]))
        assert doc["state"] == JOB_STATE_DONE and doc["result"]["loss"] == 0.0
    if name == "fs412_orphan_with_acked_records":
        assert [t for t, _ in _replayed(tft, qt)] == [d["tid"] for d in docs] + [77]


@pytest.mark.parametrize("fixer", ["jax", "torch"])
def test_either_packages_fsck_repairs_the_others_queue(tmp_path, fixer):
    """A queue one package wrote and a writer killed mid-operation left
    damaged (torn doc, orphan lease and lock, tmp dropping, stuck id lock)
    is repaired by the other package's fsck, and the writer's own package
    then reads it clean."""
    writer_ft = tft if fixer == "jax" else jft
    fix = jfsck if fixer == "jax" else tfsck
    check = tfsck if fixer == "jax" else jfsck
    q = str(tmp_path / "q")
    trials, docs = _mk_queue(writer_ft, q)
    for d in (d_fs401, d_fs402, d_fs403, d_fs406, d_fs408):
        d(q, trials, docs, writer_ft, None)
    assert set(check.fsck_queue(q).by_rule()) == {"FS401", "FS402", "FS403", "FS406",
                                                  "FS408"}
    assert fix.fsck_queue(q, repair=True).clean
    assert check.fsck_queue(q).clean
    assert [t for t, _ in _replayed(writer_ft, q)] == [d["tid"] for d in docs[1:]]


_KILL_CODE = """
import sys
sys.path.insert(0, {repo!r})
from hyperopt_tpu_torch.resilience import chaos
from hyperopt_tpu_torch.parallel.file_trials import FileJobs
cfg = chaos.ChaosConfig(seed=5, {site}=1.0)
with chaos.active(chaos.ChaosMonkey(cfg)):
    jobs = FileJobs({qdir!r})
    {op}
raise SystemExit("the chaos site never fired")
"""


@pytest.mark.parametrize("site,op,seal,rule", [
    ("p_torn_segment",
     'jobs.insert({"tid": 99, "state": 0, "misc": {"tid": 99}})', False, "FS410"),
    ("p_compaction_kill", "jobs.segments.compact()", True, "FS412"),
])
def test_sigkilled_port_writer_recovers(tmp_path, site, op, seal, rule):
    """A real port process SIGKILLed inside a segment group commit, or
    between a compaction's manifest publish and its unlinks: both fscks
    find the same damage; the repair keeps every acked doc and the unacked
    append vanishes whole."""
    q = str(tmp_path / "q")
    trials, docs = _mk_queue(tft, q, n_docs=2, backend="segment")
    if seal:
        trials.jobs.segments.seal_active()
    proc = subprocess.run([sys.executable, "-c", _KILL_CODE.format(
        repo=REPO, site=site, qdir=q, op=op)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == -9, (proc.returncode, proc.stderr)
    qj = str(tmp_path / "j")
    shutil.copytree(q, qj)
    dry = tfsck.fsck_queue(q)
    assert _rel(dry, q) == _rel(jfsck.fsck_queue(qj), qj) and rule in dry.by_rule()
    assert tfsck.fsck_queue(q, repair=True).clean and tfsck.fsck_queue(q).clean
    assert [t for t, _ in _replayed(tft, q)] == [d["tid"] for d in docs]


def test_cli_exit_codes_and_json(tmp_path, capsys):
    q = str(tmp_path / "q")
    trials, docs = _mk_queue(tft, q)
    assert tfsck.main([q]) == 0
    _truncate(trials.jobs.trial_path(docs[0]["tid"]), keep=3)
    capsys.readouterr()
    assert tfsck.main([q, "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["clean"] is False and out["by_rule"].get("FS401") == 1
    assert tfsck.main([q, "--repair"]) == 0
    assert tfsck.main([q]) == 0


def test_module_entry_point_and_service_root(tmp_path):
    """``python -m hyperopt_tpu_torch.resilience.fsck <queue>`` exits 0 on a
    clean queue, with no warning and without importing JAX; a service root
    (``studies/``) is checked study by study, and its replica plane
    (``replicas/``, FS409) with it."""
    q = str(tmp_path / "q")
    _mk_queue(tft, q)
    code = ("import runpy, sys\n"
            f"sys.argv = ['fsck', {q!r}]\n"
            "try:\n"
            "    runpy.run_module('hyperopt_tpu_torch.resilience.fsck', run_name='__main__',\n"
            "                     alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('hyperopt_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-W", "error", "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
    out = subprocess.run([sys.executable, "-W", "error", "-m",
                          "hyperopt_tpu_torch.resilience.fsck", q],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and not out.stderr, out.stderr
    os.makedirs(tmp_path / "root" / "studies")
    shutil.copytree(q, tmp_path / "root" / "studies" / "s")
    report = tfsck.fsck_path(str(tmp_path / "root"))
    assert report.clean and report.summary()["n_queues"] == 1
    os.makedirs(tmp_path / "root" / "replicas" / "leases")
    lock = tmp_path / "root" / "replicas" / "leases" / "s.claimlock"
    lock.write_text("")
    os.utime(lock, (0, 0))  # a claimant killed mid-claim long ago
    report = tfsck.fsck_path(str(tmp_path / "root"))
    assert [f.rule for f in report.findings] == ["FS409"]
    assert report.summary()["n_queues"] == 1
    assert tfsck.fsck_path(str(tmp_path / "root"), repair=True).clean
    assert tfsck.fsck_path(str(tmp_path / "root")).clean
    assert tfsck.fsck_path(q).clean
