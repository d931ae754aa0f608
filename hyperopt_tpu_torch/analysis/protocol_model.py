"""Tier B: explicit-state model checker for the segment protocol.

Pure Python, no jax.  The appender / sealer / compactor / orphan
sweeper / mirror / takeover roles of the segmented trial store and its
replication plane are encoded as guarded-transition state machines
over an abstract disk, and every interleaving is explored breadth-
first over small scopes (2-3 processes, <=6 steps each), with a
**crash injected after every durable step** — the process dies with
its durable effect applied and its volatile continuation lost, the
power-loss shape fsck recovers from.

Checked invariants (each scenario selects which apply):

- ``acked-durable``    — no acked record is lost: every acked
  (tid, ver) is either superseded by a newer acked version or present
  in SOME on-disk file (manifest-referenced or orphan), i.e. still
  recoverable by an offline fsck.
- ``single-sealer``    — at most one process inside the seal/compact
  critical section at a time.
- ``manifest-commit``  — the manifest never dangles: every referenced
  segment exists with at least the pinned record count (the manifest
  is the commit point, so it must only ever describe durable state).
- ``fence-monotone``   — fence tokens never move backwards (an edge
  invariant, checked across every transition).
- ``sidecar-monotone`` — acked sidecar state (response journal / id
  counter) never regresses to a stale snapshot.
- ``view-consistency`` — a completed appender's materialized view
  covers everything acked at the time of its final refresh (the
  replayed view equals the log's latest-per-tid).

Validated by mutation: each of the four known protocol bug classes can be
re-injected (:data:`MUTATIONS`) and the checker must find a violating
trace, printed as a human-readable schedule::

    schedule (appender-cursor (bug=cursor-max-advance)):
      1. A.refresh
      2. B.refresh
      3. A.append [durable]
      4. B.append [durable]
      5. B.advance
      6. B.final_refresh
    violated: view-consistency: appender B finished with a view
    missing acked record (1, 1) ...

The default (CI-gate) scope runs every scenario with crash budget 1;
``deep=True`` raises the budget to 2 crashes per run — the full sweep
behind ``--deep`` / the ``slow`` test tier.  State spaces are a few
thousand states per scenario, so the default sweep stays well inside
the lint-gate time budget.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, apply_suppressions, make

__all__ = [
    "MUTATIONS",
    "SCENARIOS",
    "Scenario",
    "Step",
    "Violation",
    "build_scenario",
    "check_all",
    "check_mutation",
    "find_violation",
    "format_schedule",
    "model_check_diagnostics",
]


@dataclass(frozen=True)
class Step:
    """One guarded transition of one process.  ``fn(state, me)``
    mutates a fresh copy of the global state; ``guard(state, me)``
    says whether the step is enabled (disabled steps simply wait).
    ``durable`` marks the effect as surviving a crash of the process
    immediately after the step."""

    name: str
    fn: Callable
    durable: bool = False
    guard: Optional[Callable] = None


@dataclass
class Scenario:
    name: str
    procs: Dict[str, List[Step]]
    initial_disk: dict
    invariants: List[Callable] = field(default_factory=list)
    # edge invariants see (prev_disk, next_disk) on every transition
    edge_invariants: List[Callable] = field(default_factory=list)


@dataclass
class Violation:
    scenario: str
    invariant: str
    message: str
    schedule: List[str]

    def format(self) -> str:
        return format_schedule(self)


def format_schedule(v: Violation) -> str:
    lines = [f"schedule ({v.scenario}):"]
    for i, label in enumerate(v.schedule, 1):
        lines.append(f"  {i}. {label}")
    lines.append(f"violated: {v.invariant}: {v.message}")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# Explorer
# ---------------------------------------------------------------------


def _freeze(obj):
    """Canonical hashable form of a state; keys starting with ``_``
    are static metadata and stay out of the identity."""
    if isinstance(obj, dict):
        return tuple(sorted(
            (k, _freeze(v)) for k, v in obj.items()
            if not (isinstance(k, str) and k.startswith("_"))
        ))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, set):
        return tuple(sorted(_freeze(v) for v in obj))
    return obj


def _done(state, name) -> bool:
    p = state["procs"][name]
    return p["pc"] >= state["_proc_lens"][name]


def find_violation(
    scenario: Scenario, crash_budget: int = 1, max_states: int = 200000
) -> Optional[Violation]:
    """BFS over every interleaving (plus a crash branch after each
    durable step while the crash budget lasts); the first state
    violating an invariant wins, its schedule reconstructed from the
    BFS parent links — so reported schedules are shortest-first.
    None when the full state space satisfies every invariant."""
    init = {
        "disk": copy.deepcopy(scenario.initial_disk),
        "procs": {
            name: {"pc": 0, "alive": True, "vars": {}}
            for name in scenario.procs
        },
        "crashes": 0,
        "_proc_lens": {
            name: len(steps) for name, steps in scenario.procs.items()
        },
    }
    init_key = _freeze(init)
    parents: Dict[tuple, Tuple[Optional[tuple], Optional[str]]] = {
        init_key: (None, None)
    }

    def schedule_of(key) -> List[str]:
        out: List[str] = []
        while key is not None:
            key, label = parents[key]
            if label is not None:
                out.append(label)
        return list(reversed(out))

    def check(state, key) -> Optional[Violation]:
        for inv in scenario.invariants:
            msg = inv(state)
            if msg:
                return Violation(
                    scenario.name, getattr(inv, "inv_name", inv.__name__),
                    msg, schedule_of(key),
                )
        return None

    v = check(init, init_key)
    if v is not None:
        return v
    frontier = [(init, init_key)]
    seen = 1
    while frontier:
        next_frontier = []
        for state, key in frontier:
            for pname, steps in scenario.procs.items():
                proc = state["procs"][pname]
                if not proc["alive"] or proc["pc"] >= len(steps):
                    continue
                step = steps[proc["pc"]]
                if step.guard is not None and not step.guard(state, pname):
                    continue
                base = copy.deepcopy(state)
                step.fn(base, pname)
                base["procs"][pname]["pc"] += 1
                suffix = " [durable]" if step.durable else ""
                branches = [(base, f"{pname}.{step.name}{suffix}")]
                if step.durable and state["crashes"] < crash_budget:
                    crashed = copy.deepcopy(base)
                    crashed["procs"][pname]["alive"] = False
                    crashed["procs"][pname]["vars"] = {}
                    crashed["crashes"] += 1
                    branches.append((
                        crashed,
                        f"{pname}.{step.name}{suffix} ** CRASH {pname}",
                    ))
                for ns, label in branches:
                    nkey = _freeze(ns)
                    if nkey in parents:
                        continue
                    parents[nkey] = (key, label)
                    for einv in scenario.edge_invariants:
                        msg = einv(state["disk"], ns["disk"])
                        if msg:
                            return Violation(
                                scenario.name,
                                getattr(einv, "inv_name",
                                        einv.__name__),
                                msg, schedule_of(nkey),
                            )
                    v = check(ns, nkey)
                    if v is not None:
                        return v
                    seen += 1
                    if seen > max_states:
                        raise RuntimeError(
                            f"protocol model {scenario.name}: state "
                            f"space exceeds {max_states} states"
                        )
                    next_frontier.append((ns, nkey))
        frontier = next_frontier
    return None


# ---------------------------------------------------------------------
# Shared disk helpers (abstract records are (tid, ver) tuples)
# ---------------------------------------------------------------------


def _replay(disk) -> Dict[int, int]:
    """latest-per-tid view of the manifest-referenced lineage."""
    view: Dict[int, int] = {}
    manifest = disk["manifest"]
    if manifest is None:
        return view
    for name, nrec in manifest["sealed"]:
        for tid, ver in disk["files"].get(name, ())[:nrec]:
            if ver >= view.get(tid, -1):
                view[tid] = ver
    for tid, ver in disk["files"].get(manifest["active"], ()):
        if ver >= view.get(tid, -1):
            view[tid] = ver
    return view


def _recoverable(disk) -> Dict[int, int]:
    """latest-per-tid over EVERY on-disk file, orphans included — what
    an offline fsck can still salvage."""
    view: Dict[int, int] = {}
    for recs in disk["files"].values():
        for tid, ver in recs:
            if ver >= view.get(tid, -1):
                view[tid] = ver
    return view


def _named(name):
    def deco(fn):
        fn.inv_name = name
        return fn
    return deco


@_named("acked-durable")
def _inv_acked_recoverable(state):
    got = _recoverable(state["disk"])
    for tid, ver in state["disk"]["acked"]:
        if got.get(tid, -1) < ver:
            return (
                f"acked record ({tid}, {ver}) exists in no on-disk "
                "file and is not superseded — unrecoverable even by "
                "fsck"
            )
    return None


@_named("manifest-commit")
def _inv_manifest_no_dangle(state):
    disk = state["disk"]
    manifest = disk["manifest"]
    if manifest is None:
        return None
    for name, nrec in manifest["sealed"]:
        have = len(disk["files"].get(name, ()))
        if have < nrec:
            return (
                f"manifest pins {nrec} record(s) of {name} but only "
                f"{have} exist — the commit point dangles"
            )
    return None


@_named("single-sealer")
def _inv_single_sealer(state):
    inside = [
        name for name, p in state["procs"].items()
        if p["alive"] and p["vars"].get("in_cs")
    ]
    if len(inside) > 1:
        return (
            "two processes inside the seal/compact critical section: "
            + ", ".join(sorted(inside))
        )
    return None


@_named("view-consistency")
def _inv_view_consistency(state):
    for name, p in state["procs"].items():
        if not p["alive"] or not p["vars"].get("done"):
            continue
        view = p["vars"].get("view", {})
        for tid, ver in p["vars"].get("acked_at_done", ()):
            if view.get(tid, -1) < ver:
                return (
                    f"appender {name} finished with a view missing "
                    f"acked record ({tid}, {ver}) — its cursor "
                    "skipped log bytes it never applied"
                )
    return None


@_named("fence-monotone")
def _edge_fence_monotone(prev_disk, next_disk):
    for root in ("fence", "dst_fence"):
        if root in prev_disk and next_disk[root] < prev_disk[root]:
            return (
                f"{root} moved backwards: {prev_disk[root]} -> "
                f"{next_disk[root]}"
            )
    return None


@_named("sidecar-monotone")
def _inv_sidecar_monotone(state):
    disk = state["disk"]
    if disk["sidecar"] < disk["sidecar_acked"]:
        return (
            f"sidecar state regressed to {disk['sidecar']} below the "
            f"acked floor {disk['sidecar_acked']} — post-takeover "
            "journal/id state clobbered by a stale snapshot"
        )
    return None


# ---------------------------------------------------------------------
# Scenario: appender-cursor (known bug: non-contiguous cursor advance)
# ---------------------------------------------------------------------


def _appender(rec, bug_max_advance=False):
    tid, ver = rec

    def refresh(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        active = disk["manifest"]["active"]
        recs = disk["files"].get(active, ())
        view = dict(v.get("view", {}))
        for t, vv in recs:
            if vv >= view.get(t, -1):
                view[t] = vv
        v.update(active=active, cursor=len(recs), view=view)

    def append(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        a = v["active"]
        disk["files"][a] = disk["files"].get(a, ()) + ((tid, ver),)
        disk["acked"] = disk["acked"] + ((tid, ver),)
        v["end"] = len(disk["files"][a])

    def advance(state, me):
        v = state["procs"][me]["vars"]
        view = dict(v["view"])
        if ver >= view.get(tid, -1):
            view[tid] = ver  # own doc always applied to the view
        v["view"] = view
        if bug_max_advance:
            # known bug: jump the cursor past bytes never applied
            v["cursor"] = max(v["cursor"], v["end"])
        elif v["cursor"] == v["end"] - 1:
            v["cursor"] = v["end"]  # contiguous: safe to skip replay

    def final_refresh(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        recs = disk["files"].get(v["active"], ())
        view = dict(v["view"])
        for t, vv in recs[v["cursor"]:]:
            if vv >= view.get(t, -1):
                view[t] = vv
        v.update(
            view=view, cursor=len(recs), done=True,
            acked_at_done=disk["acked"],
        )

    return [
        Step("refresh", refresh),
        Step("append", append, durable=True),
        Step("advance", advance),
        Step("final_refresh", final_refresh),
    ]


def _scenario_appender_cursor(bug=None) -> Scenario:
    return Scenario(
        name="appender-cursor"
        + (" (bug=cursor-max-advance)" if bug else ""),
        procs={
            "A": _appender((1, 1), bug_max_advance=bool(bug)),
            "B": _appender((2, 1), bug_max_advance=bool(bug)),
        },
        initial_disk={
            "files": {"seg1": ()},
            "manifest": {"epoch": 0, "active": "seg1", "sealed": ()},
            "acked": (),
        },
        invariants=[_inv_acked_recoverable, _inv_view_consistency],
    )


# ---------------------------------------------------------------------
# Scenario: seal-lock (known bug: breaking a stale lock by unlink)
# ---------------------------------------------------------------------


def _sealer(bug_unlink_break=False):
    def acquire(state, me):
        # fixed idiom collapses to ONE atomic commit point: O_EXCL
        # create on an absent lock, or winning the rename of a stale
        # one (rename is atomic — exactly one breaker wins)
        state["disk"]["lock"] = me
        state["procs"][me]["vars"]["in_cs"] = True

    def acquire_guard(state, me):
        return state["disk"]["lock"] in (None, "STALE")

    def judge(state, me):
        state["procs"][me]["vars"]["judged_stale"] = True

    def judge_guard(state, me):
        return state["disk"]["lock"] == "STALE"

    def break_unlink(state, me):
        # known bug: unlink the SHARED path — removes whatever lock is
        # there NOW, including one a faster breaker just re-created
        state["disk"]["lock"] = None

    def take(state, me):
        state["disk"]["lock"] = me
        state["procs"][me]["vars"]["in_cs"] = True

    def take_guard(state, me):
        return state["disk"]["lock"] is None

    def seal(state, me):
        disk = state["disk"]
        m = disk["manifest"]
        active = m["active"]
        n = len(disk["files"].get(active, ()))
        nxt = "seg%d" % (int(active[3:]) + 1)
        disk["files"].setdefault(nxt, ())
        disk["manifest"] = {
            "epoch": m["epoch"],
            "active": nxt,
            "sealed": m["sealed"] + ((active, n),),
        }

    def release(state, me):
        disk = state["disk"]
        if disk["lock"] == me:
            disk["lock"] = None
        state["procs"][me]["vars"]["in_cs"] = False

    if bug_unlink_break:
        entry = [
            Step("judge_stale", judge, guard=judge_guard),
            Step("break_unlink_shared", break_unlink),
            Step("take_lock", take, guard=take_guard),
        ]
    else:
        entry = [Step("acquire_or_break", acquire, guard=acquire_guard)]
    return entry + [
        Step("publish_seal", seal, durable=True),
        Step("release", release),
    ]


def _scenario_seal_lock(bug=None) -> Scenario:
    return Scenario(
        name="seal-lock" + (" (bug=unlink-lock-break)" if bug else ""),
        procs={
            "S1": _sealer(bug_unlink_break=bool(bug)),
            "S2": _sealer(bug_unlink_break=bool(bug)),
        },
        initial_disk={
            "files": {"seg1": ((1, 1),)},
            "manifest": {"epoch": 0, "active": "seg1", "sealed": ()},
            "acked": ((1, 1),),
            "lock": "STALE",  # a SIGKILL'd sealer left its lock behind
        },
        invariants=[
            _inv_single_sealer,
            _inv_acked_recoverable,
            _inv_manifest_no_dangle,
        ],
    )


# ---------------------------------------------------------------------
# Scenario: compact-sweep (known bug: orphan sweep without re-home)
# ---------------------------------------------------------------------


def _late_appender(rec):
    """An appender whose post-append manifest re-check can be cut off
    by a crash — the shape that strands acked records in a segment the
    compactor's swap just orphaned."""
    tid, ver = rec

    def append(state, me):
        disk = state["disk"]
        a = disk["manifest"]["active"]
        disk["files"][a] = disk["files"].get(a, ()) + ((tid, ver),)
        disk["acked"] = disk["acked"] + ((tid, ver),)
        state["procs"][me]["vars"]["wrote_to"] = a

    def post_check(state, me):
        # the appender's own post-write manifest re-check: re-home its
        # records when a concurrent swap cut the segment under it
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        m = disk["manifest"]
        wrote_to = v["wrote_to"]
        survives = wrote_to == m["active"] or any(
            name == wrote_to
            and (tid, ver) in disk["files"].get(name, ())[:nrec]
            for name, nrec in m["sealed"]
        )
        if not survives:
            a = m["active"]
            disk["files"][a] = disk["files"].get(a, ()) + ((tid, ver),)

    return [
        Step("append", append, durable=True),
        Step("post_check_rehome", post_check, durable=True),
    ]


def _compactor():
    def refresh(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        m = disk["manifest"]
        v["view"] = tuple(sorted(_replay(disk).items()))
        v["old_active"] = m["active"]
        v["consumed"] = len(disk["files"].get(m["active"], ()))
        v["old_names"] = tuple(
            [name for name, _ in m["sealed"]] + [m["active"]]
        )
        v["in_cs"] = True

    def write_base(state, me):
        v = state["procs"][me]["vars"]
        state["disk"]["files"]["base3"] = tuple(v["view"])

    def swap_manifest(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        disk["files"].setdefault("seg9", ())
        disk["manifest"] = {
            "epoch": disk["manifest"]["epoch"] + 1,
            "active": "seg9",
            "sealed": (("base3", len(v["view"])),),
        }

    def rehome(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        tail = disk["files"].get(v["old_active"], ())[v["consumed"]:]
        a = disk["manifest"]["active"]
        disk["files"][a] = disk["files"].get(a, ()) + tail

    def unlink_old(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        for name in v["old_names"]:
            disk["files"].pop(name, None)
        v["in_cs"] = False

    return [
        Step("refresh", refresh),
        Step("write_base", write_base, durable=True),
        Step("swap_manifest", swap_manifest, durable=True),
        Step("rehome_stragglers", rehome, durable=True),
        Step("unlink_old", unlink_old, durable=True),
    ]


def _sweeper(bug_no_rehome=False, rounds=2):
    """Offline fsck FS412: runs only once every online process is done
    or dead; deletes manifest-unreferenced files, re-homing their
    unsuperseded records first (unless the bug is re-injected)."""

    def offline_guard(state, me):
        return all(
            name == me or not p["alive"] or _done(state, name)
            for name, p in state["procs"].items()
        )

    def scan(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        m = disk["manifest"]
        referenced = {name for name, _ in m["sealed"]} | {m["active"]}
        orphans = sorted(set(disk["files"]) - referenced)
        v["orphan"] = orphans[0] if orphans else None

    def rehome(state, me):
        v = state["procs"][me]["vars"]
        disk = state["disk"]
        orphan = v.get("orphan")
        if orphan is None or bug_no_rehome:
            return  # known bug: straight to the unlink
        have = _replay(disk)
        latest: Dict[int, int] = {}
        for tid, ver in disk["files"].get(orphan, ()):
            if ver >= latest.get(tid, -1):
                latest[tid] = ver
        stragglers = tuple(
            (tid, ver) for tid, ver in sorted(latest.items())
            if have.get(tid, -1) < ver
        )
        if stragglers:
            a = disk["manifest"]["active"]
            disk["files"][a] = disk["files"].get(a, ()) + stragglers

    def unlink(state, me):
        orphan = state["procs"][me]["vars"].get("orphan")
        if orphan is not None:
            state["disk"]["files"].pop(orphan, None)

    steps: List[Step] = []
    for i in range(1, rounds + 1):
        steps.extend([
            Step(f"scan_orphans_{i}", scan, guard=offline_guard),
            Step(f"rehome_stragglers_{i}", rehome, durable=True,
                 guard=offline_guard),
            Step(f"unlink_orphan_{i}", unlink, durable=True,
                 guard=offline_guard),
        ])
    return steps


def _scenario_compact_sweep(bug=None) -> Scenario:
    return Scenario(
        name="compact-sweep" + (" (bug=sweep-no-rehome)" if bug else ""),
        procs={
            "A": _late_appender((3, 1)),
            "C": _compactor(),
            "W": _sweeper(bug_no_rehome=bool(bug)),
        },
        initial_disk={
            "files": {"seg1": ((1, 1),), "seg2": ((2, 1),)},
            "manifest": {
                "epoch": 0, "active": "seg2",
                "sealed": (("seg1", 1),),
            },
            "acked": ((1, 1), (2, 1)),
        },
        invariants=[_inv_acked_recoverable, _inv_manifest_no_dangle],
    )


# ---------------------------------------------------------------------
# Scenario: replication (known bug: post-takeover mirror clobber)
# ---------------------------------------------------------------------


def _mirror(bug_no_owner_check=False):
    def check_owner(state, me):
        v = state["procs"][me]["vars"]
        if bug_no_owner_check:
            v["skip"] = False  # known bug: pull regardless of takeover
        else:
            v["skip"] = state["disk"]["dst_owner"] is not None

    def read_fence(state, me):
        v = state["procs"][me]["vars"]
        if not v["skip"]:
            v["f0"] = state["disk"]["fence"]

    def copy_segments(state, me):
        v = state["procs"][me]["vars"]
        if v["skip"]:
            return
        disk = state["disk"]
        for name, recs in disk["src_files"].items():
            disk["files"][name] = recs

    def copy_sidecars(state, me):
        v = state["procs"][me]["vars"]
        if v["skip"]:
            return
        state["disk"]["sidecar"] = state["disk"]["src_sidecar"]

    def recheck_fence(state, me):
        v = state["procs"][me]["vars"]
        if not v["skip"]:
            v["f1"] = state["disk"]["fence"]

    def publish_manifest(state, me):
        v = state["procs"][me]["vars"]
        if v["skip"] or v["f0"] != v["f1"]:
            return  # fence moved mid-pull: manifest withheld
        state["disk"]["manifest"] = copy.deepcopy(
            state["disk"]["src_manifest"]
        )

    return [
        Step("check_dst_owner", check_owner),
        Step("read_fence", read_fence),
        Step("copy_segments", copy_segments, durable=True),
        Step("copy_sidecars", copy_sidecars, durable=True),
        Step("recheck_fence", recheck_fence),
        Step("publish_manifest", publish_manifest, durable=True),
    ]


def _takeover():
    def serialized_guard(state, me):
        # pulls and takeovers run on ONE reaper thread per replica: a
        # takeover never starts while the same replica is mid-pull
        return all(
            not p["alive"] or p["pc"] == 0 or _done(state, name)
            for name, p in state["procs"].items()
            if name.startswith("M")
        )

    def claim(state, me):
        disk = state["disk"]
        disk["dst_owner"] = me
        disk["dst_fence"] += 1

    def write_post(state, me):
        disk = state["disk"]
        a = disk["manifest"]["active"]
        disk["files"][a] = disk["files"].get(a, ()) + ((9, 1),)
        disk["acked"] = disk["acked"] + ((9, 1),)
        disk["sidecar"] += 1
        disk["sidecar_acked"] = disk["sidecar"]

    return [
        Step("claim_takeover", claim, durable=True,
             guard=serialized_guard),
        Step("write_post_takeover", write_post, durable=True),
    ]


def _scenario_replication(bug=None) -> Scenario:
    src_manifest = {"epoch": 0, "active": "a", "sealed": (("s1", 1),)}
    return Scenario(
        name="replication" + (" (bug=mirror-clobber)" if bug else ""),
        procs={
            # two mirror ticks: one can land entirely after the takeover
            "M1": _mirror(bug_no_owner_check=bool(bug)),
            "M2": _mirror(bug_no_owner_check=bool(bug)),
            "T": _takeover(),
        },
        initial_disk={
            # destination root (the one being written)
            "files": {"s1": ((1, 1),), "a": ()},
            "manifest": copy.deepcopy(src_manifest),
            "acked": ((1, 1),),
            "sidecar": 5,       # response journal / id counter, abstract
            "sidecar_acked": 5,
            "dst_owner": None,
            "dst_fence": 0,
            # source root (read-only here; its owner is dead)
            "src_files": {"s1": ((1, 1),)},
            "src_manifest": src_manifest,
            "src_sidecar": 5,
            "fence": 3,
        },
        invariants=[
            _inv_acked_recoverable,
            _inv_sidecar_monotone,
            _inv_manifest_no_dangle,
        ],
        edge_invariants=[_edge_fence_monotone],
    )


SCENARIOS = {
    "appender-cursor": _scenario_appender_cursor,
    "seal-lock": _scenario_seal_lock,
    "compact-sweep": _scenario_compact_sweep,
    "replication": _scenario_replication,
}

# known protocol bug class -> the scenario that must expose it when re-injected
MUTATIONS = {
    "cursor-max-advance": "appender-cursor",
    "unlink-lock-break": "seal-lock",
    "sweep-no-rehome": "compact-sweep",
    "mirror-clobber": "replication",
}


def build_scenario(name: str, bug: Optional[str] = None) -> Scenario:
    """Build scenario ``name``; ``bug`` (a MUTATIONS key mapping to
    this scenario) re-injects that known bug class."""
    if bug is not None and MUTATIONS.get(bug) != name:
        raise ValueError(f"bug {bug!r} does not belong to {name!r}")
    return SCENARIOS[name](bug)


def check_all(deep: bool = False, scenarios=None):
    """Run every (bug-free) scenario; returns [(name, Violation|None)].
    ``deep`` raises the crash budget from 1 to 2 — the full sweep the
    slow tier / ``--deep`` runs."""
    crash_budget = 2 if deep else 1
    return [
        (name, find_violation(build_scenario(name),
                              crash_budget=crash_budget))
        for name in (scenarios or sorted(SCENARIOS))
    ]


def check_mutation(bug: str, deep: bool = False) -> Optional[Violation]:
    """Re-inject known bug class ``bug`` into its scenario and model-
    check it; a correct checker returns a Violation with a schedule."""
    return find_violation(
        build_scenario(MUTATIONS[bug], bug=bug),
        crash_budget=2 if deep else 1,
    )


def model_check_diagnostics(deep: bool = False, suppress=()):
    """The Tier B gate: every scenario violation as an SG706
    diagnostic whose message carries the human-readable schedule."""
    diags: List[Diagnostic] = []
    for name, violation in check_all(deep=deep):
        if violation is None:
            continue
        diags.append(make(
            "SG706",
            f"protocol_model:{name}",
            f"{violation.invariant}: {violation.message}\n"
            + format_schedule(violation),
            hint="reproduce with analysis.protocol_model."
                 f"build_scenario({name!r}) + find_violation()",
        ))
    return apply_suppressions(diags, suppress)
