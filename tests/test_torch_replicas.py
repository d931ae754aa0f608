"""The port's replica plane (``hyperopt_tpu_torch.service.replicas`` and the
replica paths of the service, the CLI, fsck and SL608) against the JAX
package's, on the CPU.

The JAX package's replica tests run against the port with
``device="cpu"``: ``TestPerEndpointBreaker``, ``TestRoutingRegressions``
and ``TestReplicaServing`` (``tests/test_service.py``), the segment
mirror, its twin-trajectory failover and the shared compile cache, which
the port allows where the reference refuses it
(``tests/test_segment_replication.py``), FS409
(``tests/test_fsck.py``) and the cross-process lease contention of
``tests/test_resilience.py``'s ``TestReplicaLeases``; then SL608 over
``ReplicaStats``.  Then what only the port has to show: lease, fence and
registry files read and claimed across the two packages, FS409's
findings and repairs equal to the JAX package's on the same damage, a
takeover's pre-warm dispatched on the scheduler thread only, a migrated
study equal to a single-replica twin (and, for ``anneal``, to the JAX
service's served docs), a compile ledger shared by two replicas, and the
CLI's replica flags with a ``kill -9`` failover across two processes.

Lease TTLs are chosen for what each test shows, never so short that a
heartbeat stalled by a loaded machine reads as a dead replica.  Every
wait has a bound and every server, thread and process is stopped in a
``finally``; no assertion follows a fixed sleep.

Run as a script (``python tests/test_torch_replicas.py ROOT STUDY ID
MODE [N]``) this file is the cross-process lease helper of the
contention tests.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

WAIT_S = 120  # the bound of every wait below; none is reached when the code is right


def _lease_helper(argv):
    """Subprocess body of the contention tests (port only, no JAX).

    - ``race``: write ``ready-<id>``, park until the parent drops a
      ``go`` file, then attempt ONE claim — two of these are a real
      two-process race on the ``O_CREAT|O_EXCL`` claim lock;
    - ``cycle N``: N claim→release cycles, spinning while the peer
      holds the lease; prints the fences this process observed.

    Prints one JSON line; returns the exit code."""
    root, study, rid, mode = argv[:4]
    from hyperopt_tpu_torch.service.replicas import StudyLeaseStore

    store = StudyLeaseStore(root, ttl=5.0)
    deadline = time.time() + 60.0
    if mode == "race":
        with open(os.path.join(root, f"ready-{rid}"), "w") as f:
            f.write("ready")
        go = os.path.join(root, "go")
        while not os.path.exists(go):
            if time.time() > deadline:
                print(json.dumps({"replica": rid, "error": "timeout"}))
                return 1
            time.sleep(0.001)
        print(json.dumps({"replica": rid, "fence": store.claim(study, rid)}))
        return 0
    if mode == "cycle":
        fences = []
        for _ in range(int(argv[4])):
            fence = None
            while fence is None:
                fence = store.claim(study, rid)
                if fence is None:
                    if time.time() > deadline:
                        print(json.dumps({"replica": rid, "error": "starved"}))
                        return 1
                    time.sleep(0.002)
            fences.append(fence)
            store.release(study, rid, fence)
        print(json.dumps({"replica": rid, "fences": fences}))
        return 0
    print(json.dumps({"replica": rid, "error": f"bad mode {mode}"}))
    return 2


if __name__ == "__main__":
    sys.exit(_lease_helper(sys.argv[1:]))


import numpy as np  # noqa: E402
import pytest  # noqa: E402

import hyperopt_tpu as J  # noqa: E402
from chip_smoke import spawn_service, spread_names  # noqa: E402
from hyperopt_tpu.service import OptimizationService as JaxService  # noqa: E402
from hyperopt_tpu.service import replicas as jrep  # noqa: E402
from hyperopt_tpu_torch import Trials, fmin, hp  # noqa: E402
from hyperopt_tpu_torch.algos import tpe, tpe_device  # noqa: E402
from hyperopt_tpu_torch.fmin import space_eval  # noqa: E402
from hyperopt_tpu_torch.resilience.fsck import fsck_path, fsck_queue  # noqa: E402
from hyperopt_tpu_torch.service import (  # noqa: E402
    NotOwner,
    OptimizationService,
    ServiceClient,
    ServiceServer,
    free_port,
)
from hyperopt_tpu_torch.service import replicas as trep  # noqa: E402
from hyperopt_tpu_torch.service.replicas import (  # noqa: E402
    ReplicaDirectory,
    ReplicaSet,
    ReplicaStats,
    SegmentMirror,
    StudyLeaseStore,
)


def Svc(**kw):
    """The port's service on the CPU (its default is the card)."""
    kw.setdefault("device", "cpu")
    return OptimizationService(**kw)


SPACE = {
    "x": hp.uniform("x", -5, 5),
    "c": hp.choice("c", ["a", "b"]),
    "w": hp.quniform("w", 0, 10, 1),
}
J_SPACE = {
    "x": J.hp.uniform("x", -5, 5),
    "c": J.hp.choice("c", ["a", "b"]),
    "w": J.hp.quniform("w", 0, 10, 1),
}
RAP = {"n_startup_jobs": 2, "n_EI_candidates": 16}
SERVE_TTL = 2.0  # heartbeats every 0.67 s: no false failover under load


def _objective(cfg):
    return (
        (cfg["x"] - 1.0) ** 2
        + (0.5 if cfg["c"] == "b" else 0.0)
        + 0.1 * cfg["w"]
    )


def _wait_until(pred, timeout=WAIT_S, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _sleep_past(t_wall):
    """Sleep until the wall clock is past ``t_wall`` (a lease's expiry)."""
    while time.time() <= t_wall:
        time.sleep(max(min(t_wall - time.time(), 0.05), 0.001) + 0.001)


def _serial_fmin_vals(seed, max_evals, ap=RAP):
    trials = Trials()
    from functools import partial

    fmin(
        _objective, SPACE, algo=partial(tpe.suggest, device="cpu", **ap),
        max_evals=max_evals, trials=trials,
        rstate=np.random.default_rng(seed), show_progressbar=False,
        verbose=False, max_speculation=0,
    )
    return [
        {k: v[0] for k, v in t["misc"]["vals"].items() if len(v)}
        for t in trials.trials
    ]


def _study_vals_on_disk(root, study_id):
    """Per-trial vals trajectory read straight off the shared store."""
    from hyperopt_tpu_torch.parallel.file_trials import FileTrials

    qdir = os.path.join(root, "studies", study_id)
    docs = sorted(
        FileTrials(qdir)._dynamic_trials, key=lambda d: int(d["tid"])
    )
    return [
        {k: v[0] for k, v in d["misc"]["vals"].items() if len(v)}
        for d in docs
    ]


def _assert_vals_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.isclose(g[k], w[k]), (k, g, w)


def _replica_pair(root, ttl=SERVE_TTL, **kw):
    """Two replicas in-process: two OptimizationService + ServiceServer
    pairs sharing one root, with pre-allocated ports so the advertise
    URLs are known at construction."""
    p1, p2 = free_port(), free_port()
    u1 = f"http://127.0.0.1:{p1}"
    u2 = f"http://127.0.0.1:{p2}"
    s1 = Svc(
        root=root, replica_id="r1", advertise_url=u1, replica_ttl=ttl,
        batch_window=0.001, warmup=False, **kw,
    )
    srv1 = ServiceServer(s1, port=p1).start()
    s2 = Svc(
        root=root, replica_id="r2", advertise_url=u2, replica_ttl=ttl,
        batch_window=0.001, warmup=False, **kw,
    )
    srv2 = ServiceServer(s2, port=p2).start()
    return (s1, srv1, u1), (s2, srv2, u2)


def _crash(svc, srv):
    """Kill a replica the crash way: HTTP listener gone, heartbeats
    stopped, leases left in place to expire (nothing released)."""
    srv.httpd.shutdown()
    srv.httpd.server_close()
    svc.replica_set._stop.set()
    svc.scheduler.close(timeout=1.0)


def _stop_all(*servers):
    for srv in servers:
        srv.stop()


def _drive_client(client, sid, n):
    for _ in range(n):
        (t,) = client.suggest(sid)
        client.report(sid, t["tid"], loss=_objective(space_eval(SPACE, t["vals"])))


# ---------------------------------------------------------------------
# the JAX package's TestPerEndpointBreaker / TestRoutingRegressions
# ---------------------------------------------------------------------


class TestPerEndpointBreaker:
    def test_one_dead_replica_does_not_blackhole_the_live_one(self):
        dead = f"http://127.0.0.1:{free_port()}"  # nothing listening
        server = ServiceServer(Svc(batch_window=0.001, warmup=False)).start()
        try:
            client = ServiceClient(
                base_url=server.url, replicas=[dead],
                deadline=10.0, breaker_threshold=2,
                breaker_cooldown=30.0, failover_transport_retries=1,
                backoff_base=0.01, backoff_max=0.05,
            )
            for _ in range(3):
                client.breaker_for(dead).record_failure()
            assert client.breaker_for(dead).state == "open"
            assert client.breaker_for(server.url).state == "closed"
            assert client.healthz()
            sid = next(f"s{i}" for i in range(100) if client.ring.primary(f"s{i}") == dead)
            client.create_study(sid, SPACE, seed=0, algo_params=RAP)
            (t,) = client.suggest(sid)
            client.report(sid, t["tid"], loss=1.0)
            assert client.breaker_for(server.url).state == "closed"
        finally:
            server.stop()


def _stub_servers(handlers):
    import socketserver

    servers, urls = [], []
    for handler in handlers:
        httpd = socketserver.TCPServer(("127.0.0.1", 0), handler)
        servers.append(httpd)
        urls.append(f"http://127.0.0.1:{httpd.server_address[1]}")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return servers, urls


def _stop_stubs(servers):
    for httpd in servers:
        httpd.shutdown()
        httpd.server_close()


class TestRoutingRegressions:
    def test_redirect_ping_pong_terminates(self):
        """Two replicas whose stale owner hints point at EACH OTHER: the
        per-round hop cap ends each round, and the deadline surfaces a
        transport error instead of an unbounded busy-loop."""
        import http.server

        from hyperopt_tpu_torch.service.client import ServiceTransportError

        hits, urls = [], []

        def make_handler(other_index):
            class PingPong(http.server.BaseHTTPRequestHandler):
                def do_POST(self):
                    hits.append(1)
                    body = json.dumps(
                        {"error": "NotOwner", "owner_url": urls[other_index]}
                    ).encode()
                    self.send_response(307)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *a):
                    pass

            return PingPong

        servers, got = _stub_servers([make_handler(1), make_handler(0)])
        urls.extend(got)
        try:
            client = ServiceClient(replicas=urls, deadline=1.0, backoff_base=0.05,
                                   backoff_max=0.5)
            t0 = time.monotonic()
            with pytest.raises(ServiceTransportError):
                client.suggest("pingpong")
            assert time.monotonic() - t0 < 10.0
            assert len(hits) < 200
        finally:
            _stop_stubs(servers)

    def test_backpressure_fails_over_to_ring_successor(self):
        import http.server

        stub_hits = []

        class Draining(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                stub_hits.append(1)
                body = json.dumps({"error": "Backpressure", "detail": "draining"}).encode()
                self.send_response(503)
                self.send_header("Retry-After", "0.05")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        stubs, (stub_url,) = _stub_servers([Draining])
        server = ServiceServer(Svc(batch_window=0.001, warmup=False)).start()
        try:
            client = ServiceClient(
                replicas=[server.url, stub_url], deadline=20.0,
                retry_timeout=0.2, backoff_base=0.01, backoff_max=0.05,
            )
            sid = next(f"bp{i}" for i in range(100)
                       if client.ring.primary(f"bp{i}") == stub_url)
            client.create_study(sid, SPACE, seed=0, algo_params=RAP)
            (t,) = client.suggest(sid)
            client.report(sid, t["tid"], loss=1.0)
            assert len(stub_hits) >= 1  # the stub WAS tried first
        finally:
            server.stop()
            _stop_stubs(stubs)

    def test_unkeyed_mutation_is_not_resent_across_replicas(self):
        from hyperopt_tpu_torch.service import ServiceClientError
        from hyperopt_tpu_torch.service.client import ServiceTransportError

        dead = f"http://127.0.0.1:{free_port()}"
        server = ServiceServer(Svc(batch_window=0.001, warmup=False)).start()
        try:
            client = ServiceClient(
                replicas=[server.url, dead], deadline=10.0,
                use_idempotency_keys=False, backoff_base=0.01, backoff_max=0.05,
            )
            sid = next(f"uk{i}" for i in range(100) if client.ring.primary(f"uk{i}") == dead)
            with pytest.raises(ServiceTransportError):
                client.create_study(sid, SPACE, seed=0, algo_params=RAP)
            with pytest.raises(ServiceClientError) as e:
                client.study_status(sid)
            assert e.value.status == 404
        finally:
            server.stop()


# ---------------------------------------------------------------------
# the JAX package's TestReplicaServing
# ---------------------------------------------------------------------


class TestReplicaServing:
    def test_consistent_hash_spread_and_redirects(self, tmp_path):
        import urllib.error
        import urllib.request

        (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path))
        try:
            client = ServiceClient(replicas=[u1, u2], deadline=30.0)
            names = spread_names(client.ring, [u1, u2], 3, prefix="rs")
            for i, sid in enumerate(names):
                client.create_study(sid, SPACE, seed=i, algo_params=RAP)
            owned1 = s1.replica_set.owned_studies()
            owned2 = s2.replica_set.owned_studies()
            assert sorted(owned1 + owned2) == sorted(names)
            assert len(owned1) == len(owned2) == 3
            # a single-endpoint client pointed at the WRONG replica is
            # redirected (307 + owner hint) and lands the call
            sid = owned2[0]
            assert ServiceClient(u1, deadline=30.0).study_status(sid)["study_id"] == sid

            class _NoRedirect(urllib.request.HTTPRedirectHandler):
                def redirect_request(self, *a, **k):
                    return None

            req = urllib.request.Request(u1 + f"/v1/studies/{sid}", method="GET")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.build_opener(_NoRedirect).open(req, timeout=10)
            assert e.value.code == 307
            body = json.loads(e.value.read().decode())
            assert body["error"] == "NotOwner" and body["owner_url"] == u2
            assert e.value.headers["Location"].startswith(u2)
            # the replicas document of each side
            doc = client._request("GET", "/v1/replicas")
            assert doc["replica_mode"] is True
            assert {r["replica_id"] for r in doc["directory"]} == {"r1", "r2"}
            assert sorted(trep.read_discovery(str(tmp_path))) == sorted([u1, u2])
        finally:
            _stop_all(srv1, srv2)

    def test_failover_migrates_studies_and_preserves_trajectory(self, tmp_path):
        """A crashed replica's studies migrate to the survivor after lease
        expiry and each trajectory continues exactly: the client rides
        through on ring failover + idempotent retries."""
        (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path))
        try:
            client = ServiceClient(
                replicas=[u1, u2], deadline=60.0, retry_timeout=60.0,
                backoff_base=0.02, backoff_max=0.2, retry_seed=7,
            )
            n_pre, n_post = 3, 3
            names = spread_names(client.ring, [u1, u2], 2, prefix="fo")
            seeds = {sid: 10 + i for i, sid in enumerate(names)}
            for sid in names:
                client.create_study(sid, SPACE, seed=seeds[sid], algo_params=RAP)
            for sid in names:
                _drive_client(client, sid, n_pre)
            victims = s1.replica_set.owned_studies()
            assert len(victims) == 2  # the spread put 2 on each
            _crash(s1, srv1)
            for sid in names:
                _drive_client(client, sid, n_post)
            assert set(victims) <= set(s2.replica_set.owned_studies())
            assert s2.replica_set.stats.get("takeover") >= len(victims)
            for sid in names:
                st = client.study_status(sid)
                assert st["n_trials"] == st["n_completed"] == n_pre + n_post
                _assert_vals_close(_study_vals_on_disk(str(tmp_path), sid),
                                   _serial_fmin_vals(seeds[sid], n_pre + n_post))
            for rec in s2.replica_set.stats.takeovers():
                assert rec["ok"] is True and rec["fsck_clean"] is True
                assert rec["prewarm"] is not None
                assert set(rec["split_s"]) == {"fsck", "recover", "prewarm"}
            # no live replica was presumed dead along the way
            assert s2.replica_set.stats.get("renew_lost") == 0
            metrics = ServiceClient(u2).metrics()
            assert "hyperopt_replica_takeovers_total 2" in metrics
            assert "hyperopt_replica_lease_renew_lost_total 0" in metrics
        finally:
            _stop_all(srv1, srv2)

    def test_lease_stall_chaos_site_reclaims_and_drops(self, tmp_path):
        """The chaos lease-renewal stall: a frozen holder past the TTL
        loses its study; its credential is dead afterwards."""
        from hyperopt_tpu_torch.resilience.chaos import ChaosConfig, ChaosMonkey, active

        monkey = ChaosMonkey(ChaosConfig(seed=5, p_lease_stall=1.0, lease_stall_seconds=3.0))
        (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path), ttl=1.0)
        try:
            client = ServiceClient(replicas=[u1, u2], deadline=30.0)
            client.create_study("stall", SPACE, seed=3, algo_params=RAP)
            owner = s1 if s1.replica_set.owns("stall") else s2
            other = s2 if owner is s1 else s1
            with active(monkey):
                _wait_until(lambda: other.replica_set.owns("stall"), what="the reclaim")
            assert monkey.stats.get("chaos_lease_stall") >= 1
            handle = owner.replica_set.handle_of("stall")
            assert handle is None or not owner.replica_set.leases.verify(
                "stall", owner.replica_set.replica_id, handle.fence
            )
        finally:
            _stop_all(srv1, srv2)

    def test_client_partition_chaos_site_rides_on_failover(self, tmp_path):
        """Client↔replica dead while replica↔store stays alive: no
        failover fires, and redirects + ring retry carry the call once
        the window closes."""
        from hyperopt_tpu_torch.resilience.chaos import ChaosConfig, ChaosMonkey, active

        (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path), ttl=5.0)
        try:
            client = ServiceClient(replicas=[u1, u2], deadline=40.0, retry_timeout=40.0,
                                   backoff_base=0.02, backoff_max=0.2)
            client.create_study("pt", SPACE, seed=1, algo_params=RAP)
            owner = s1 if s1.replica_set.owns("pt") else s2
            monkey = ChaosMonkey(ChaosConfig(seed=11, p_client_partition=1.0,
                                             partition_seconds=1.0))
            with active(monkey):
                (t,) = client.suggest("pt")  # rides out the window
                client.report("pt", t["tid"], loss=0.5)
            assert monkey.stats.get("chaos_client_partition") >= 1
            assert owner.replica_set.owns("pt")
            assert client.study_status("pt")["n_completed"] == 1
        finally:
            _stop_all(srv1, srv2)


# ---------------------------------------------------------------------
# the JAX package's TestReplicaLeases (cross-process contention)
# ---------------------------------------------------------------------


def _spawn_helper(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
    )


def _helper_results(procs):
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, stderr.decode()
            out.append(json.loads(stdout.decode().strip()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


class TestReplicaLeases:
    def test_cross_process_claim_race_has_one_winner(self, tmp_path):
        """Two real processes race one claim: the O_CREAT|O_EXCL claim
        lock admits exactly one winner."""
        root = str(tmp_path)
        procs = [_spawn_helper(root, "contested", f"racer-{i}", "race") for i in range(2)]
        try:
            _wait_until(lambda: all(os.path.exists(os.path.join(root, f"ready-racer-{i}"))
                                    for i in range(2)), what="both racers parked")
        finally:
            with open(os.path.join(root, "go"), "w") as f:
                f.write("go")
        results = _helper_results(procs)
        winners = [r["fence"] for r in results if r["fence"] is not None]
        assert winners == [1], results

    def test_fencing_tokens_monotonic_across_processes(self, tmp_path):
        n = 5
        procs = [_spawn_helper(str(tmp_path), "shared", f"cycler-{i}", "cycle", n)
                 for i in range(2)]
        all_fences = []
        for rec in _helper_results(procs):
            seq = rec["fences"]
            assert seq == sorted(seq) and len(set(seq)) == len(seq), seq
            all_fences.extend(seq)
        assert len(set(all_fences)) == 2 * n and max(all_fences) == 2 * n

    def test_expired_lease_is_reclaimable_and_old_fence_dies(self, tmp_path):
        store = StudyLeaseStore(str(tmp_path), ttl=0.2)
        f1 = store.claim("s", "r1")
        assert f1 == 1
        _sleep_past(store.read("s")["expires_at"])  # frozen holder
        f2 = store.claim("s", "r2")
        assert f2 == 2
        assert not store.verify("s", "r1", f1)
        assert not store.renew("s", "r1", f1)
        assert store.claim("s", "r1") is None
        assert store.verify("s", "r2", f2)

    def test_torn_lease_never_resets_the_fence(self, tmp_path):
        store = StudyLeaseStore(str(tmp_path), ttl=60.0)
        f1 = store.claim("s", "r1")
        path = store.lease_path("s")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        assert store.read("s") is None
        assert store.claim("s", "r2") == f1 + 1
        assert not store.verify("s", "r1", f1)

    def test_stale_fenced_terminal_write_dropped_end_to_end(self, tmp_path):
        """A frozen replica whose study was reclaimed has its terminal
        report DROPPED at the commit-time fence verify: nothing lands in
        the journal or the store, and the service redirects."""
        root = str(tmp_path / "root")
        ap = {"n_startup_jobs": 2, "n_EI_candidates": 8}
        s1 = Svc(root=root, replica_id="r1", advertise_url="http://r1",
                 replica_ttl=1.0, batch_window=0.001, warmup=False)
        s2 = None
        try:
            s1.create_study("mig", SPACE, seed=3, algo="tpe", algo_params=ap)
            (t1,) = s1.suggest("mig")
            s1.report("mig", t1["tid"], loss=1.0)
            (t2,) = s1.suggest("mig")
            # freeze r1: heartbeats stop, the lease is left to expire
            s1.replica_set._stop.set()
            s1.replica_set._hb_thread.join(timeout=WAIT_S)
            _sleep_past(s1.replica_set.leases.read("mig")["expires_at"])
            s2 = Svc(root=root, replica_id="r2", advertise_url="http://r2",
                     replica_ttl=1.0, batch_window=0.001, warmup=False)
            assert "mig" in s2.registry.list()
            h1 = s1.replica_set.handle_of("mig")
            h2 = s2.replica_set.handle_of("mig")
            assert h2.fence > h1.fence
            with pytest.raises(NotOwner):
                s1.report("mig", t2["tid"], loss=0.5)
            assert s1.replica_set.stats.get("stale_write_dropped") >= 1
            assert "mig" not in s1.registry.list()  # relinquished
            assert s2.study_status("mig")["n_completed"] == 1
            s2.report("mig", t2["tid"], loss=0.5)
            assert s2.study_status("mig")["n_completed"] == 2
        finally:
            s1.close()
            if s2 is not None:
                s2.close()


# ---------------------------------------------------------------------
# the JAX package's tests/test_segment_replication.py
# ---------------------------------------------------------------------

MIRROR_SPACE = {"x": hp.uniform("x", -5, 5)}
MIRROR_AP = {"n_startup_jobs": 2, "n_EI_candidates": 8}


def _seed_study(root, study_id="s", n_trials=4):
    """A segmented FileTrials study dir with ``n_trials`` inserted docs
    and a sealed active segment (the graceful cut)."""
    from hyperopt_tpu_torch.parallel.file_trials import FileTrials

    qdir = os.path.join(root, "studies", study_id)
    ft = FileTrials(qdir)
    tids = ft.new_trial_ids(n_trials)
    ft._insert_trial_docs([{"tid": t, "state": 0, "misc": {"tid": t}} for t in tids])
    ft.jobs.segments.seal_active()
    return qdir, tids


class TestSegmentMirror:
    def test_pull_is_verified_idempotent_and_replayable(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import FileTrials

        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, n_trials=5)
        StudyLeaseStore(src).claim("s", "owner-a")
        mirror = SegmentMirror(src, dst)
        out = mirror.pull_study("s")
        assert out["ok"] and out["n_pulled"] == 1
        again = mirror.pull_study("s")
        assert again["ok"] and again["n_pulled"] == 0
        ft = FileTrials(os.path.join(dst, "studies", "s"))
        ft.refresh()
        assert sorted(d["tid"] for d in ft._dynamic_trials) == [0, 1, 2, 3, 4]

    def test_corrupt_source_segment_is_refused(self, tmp_path):
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        qdir, _ = _seed_study(src)
        seg_dir = os.path.join(qdir, "segments")
        name = next(n for n in sorted(os.listdir(seg_dir)) if n.startswith("seg-"))
        with open(os.path.join(seg_dir, name), "r+b") as f:
            f.seek(10)
            f.write(b"XXXX")
        out = SegmentMirror(src, dst).pull_study("s")
        assert not out["ok"] and "CRC" in out["reason"]
        assert not os.path.exists(os.path.join(dst, "studies", "s", "segments", "MANIFEST.json"))

    def test_fence_move_mid_pull_withholds_manifest(self, tmp_path):
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src)
        StudyLeaseStore(src).claim("s", "owner-a")

        class MovingFence(StudyLeaseStore):
            def __init__(self):
                super().__init__(src)
                self.calls = 0

            def read_fence(self, study_id):
                self.calls += 1
                base = super().read_fence(study_id)
                return base if self.calls == 1 else base + 1

        mirror = SegmentMirror(src, dst)
        mirror.leases = MovingFence()
        out = mirror.pull_study("s")
        assert not out["ok"] and "fence moved" in out["reason"]
        dst_segs = os.path.join(dst, "studies", "s", "segments")
        assert any(n.startswith("seg-") for n in os.listdir(dst_segs))
        assert not os.path.exists(os.path.join(dst_segs, "MANIFEST.json"))

    def test_same_root_is_refused(self, tmp_path):
        with pytest.raises(ValueError):
            SegmentMirror(str(tmp_path), str(tmp_path))

    def test_pull_all_covers_every_study(self, tmp_path):
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, study_id="s1", n_trials=2)
        _seed_study(src, study_id="s2", n_trials=3)
        outs = SegmentMirror(src, dst).pull_all()
        assert [o["study"] for o in outs] == ["s1", "s2"]
        assert all(o["ok"] for o in outs)

    def test_pull_refused_once_destination_owns_the_study(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import FileTrials

        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, n_trials=3)
        mirror = SegmentMirror(src, dst)
        assert mirror.pull_study("s")["ok"]
        StudyLeaseStore(dst).claim("s", "rb")
        ft = FileTrials(os.path.join(dst, "studies", "s"))
        ft.refresh()
        (tid,) = ft.new_trial_ids(1)
        ft._insert_trial_docs([{"tid": tid, "state": 0, "misc": {"tid": tid}}])
        out = mirror.pull_study("s")
        assert not out["ok"] and "live-owned" in out["reason"]
        ft2 = FileTrials(os.path.join(dst, "studies", "s"))
        ft2.refresh()
        assert tid in [d["tid"] for d in ft2._dynamic_trials]
        assert ft2.new_trial_ids(1)[0] == tid + 1
        assert mirror.pull_all(skip=lambda sid: sid == "s") == []

    def test_repeat_pull_does_not_churn_identical_state(self, tmp_path):
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, n_trials=3)
        mirror = SegmentMirror(src, dst)
        assert mirror.pull_study("s")["ok"]
        manifest = os.path.join(dst, "studies", "s", "segments", "MANIFEST.json")
        counter = os.path.join(dst, "studies", "s", "ids.counter")

        def sig():
            return tuple(getattr(os.stat(p), a) for p in (manifest, counter)
                         for a in ("st_mtime_ns", "st_ino"))

        before = sig()
        again = mirror.pull_study("s")
        assert again["ok"] and again["n_pulled"] == 0 and again["nbytes"] == 0
        assert sig() == before

    def test_pull_counts_on_the_store_stats(self, tmp_path):
        """``StoreStats`` counts the segments a pull copied."""
        from hyperopt_tpu_torch.observability import StoreStats
        from hyperopt_tpu_torch.parallel import file_trials as tft

        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, n_trials=3)
        stats = StoreStats()
        prev = tft.store_stats()
        tft.set_store_stats(stats)
        try:
            out = SegmentMirror(src, dst).pull_study("s")
        finally:
            tft.set_store_stats(prev)
        assert out["ok"] and out["n_pulled"] == 1
        assert "segment" in json.dumps(stats.summary())


class TestTwinTrajectoryFailover:
    def test_failover_target_rebuilds_from_pulled_segments(self, tmp_path):
        """Replica A serves 3 trials on its own root; the cut seals A's
        active segment; the mirror pulls the sealed log + sidecars into
        replica B's OWN root; B adopts the study from its local copy and
        serves 3 more.  The 6-trial trajectory equals one service running
        all 6, and B's rebuilt study dir is fsck-clean."""
        def objective(x):
            return (x - 1.0) ** 2

        def run_trials(svc, study_id, n):
            out = []
            for _ in range(n):
                (t,) = svc.suggest(study_id, n=1)
                x = t["vals"]["x"]
                svc.report(study_id, t["tid"], loss=objective(x))
                out.append((t["tid"], x))
            return out

        twin = Svc(root=str(tmp_path / "twin"), batch_window=0.001, warmup=False)
        try:
            twin.create_study("mig", MIRROR_SPACE, seed=7, algo="tpe", algo_params=MIRROR_AP)
            want = run_trials(twin, "mig", 6)
        finally:
            twin.close()
        root_a, root_b = str(tmp_path / "ra"), str(tmp_path / "rb")
        s1 = Svc(root=root_a, replica_id="ra", advertise_url="http://a",
                 replica_ttl=30.0, batch_window=0.001, warmup=False)
        try:
            s1.create_study("mig", MIRROR_SPACE, seed=7, algo="tpe", algo_params=MIRROR_AP)
            first = run_trials(s1, "mig", 3)
            s1.registry.get("mig").trials.jobs.segments.seal_active()
            out = SegmentMirror(root_a, root_b).pull_study("mig")
            assert out["ok"] and out["n_pulled"] >= 1
        finally:
            s1.close()
        s2 = Svc(root=root_b, replica_id="rb", advertise_url="http://b",
                 replica_ttl=30.0, batch_window=0.001, warmup=False)
        try:
            assert "mig" in s2.registry.list()
            assert s2.study_status("mig")["n_completed"] == 3
            rest = run_trials(s2, "mig", 3)
        finally:
            s2.close()
        got = first + rest
        assert [tid for tid, _ in got] == [tid for tid, _ in want]
        assert [x for _, x in got] == [x for _, x in want]
        report = fsck_queue(os.path.join(root_b, "studies", "mig"), repair=False)
        assert report.clean, report.findings

    def test_reaper_tick_pulls_through_attached_mirror(self, tmp_path):
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        _seed_study(src, n_trials=3)
        rs = ReplicaSet(dst, "rb", url="http://b", ttl=0.2)
        rs.attach_mirror(SegmentMirror(src, dst, ttl=0.2))
        rs.bind(adopt=lambda sid, reason: False, relinquish=lambda sid: None)
        rs.start()
        try:
            manifest = os.path.join(dst, "studies", "s", "segments", "MANIFEST.json")
            _wait_until(lambda: os.path.exists(manifest), what="the mirrored manifest")
        finally:
            rs.close()

    def test_service_option_attaches_the_mirror(self, tmp_path):
        """``mirror_src_root=`` needs ``replica_id=``; with it, the
        service's replica set pulls the peer root on its reaper tick."""
        src, dst = str(tmp_path / "a"), str(tmp_path / "b")
        with pytest.raises(ValueError, match="replica_id"):
            Svc(root=dst, mirror_src_root=src, warmup=False)
        svc = Svc(root=dst, replica_id="rb", advertise_url="http://b",
                  replica_ttl=30.0, mirror_src_root=src, warmup=False)
        try:
            assert isinstance(svc.replica_set.mirror, SegmentMirror)
            assert svc.replica_set.mirror.src_root == os.path.abspath(src)
        finally:
            svc.close()


class TestSharedCompileCache:
    """The reference refuses a ``--compile-cache-dir`` a live sibling
    advertises; the port's cache is the kernel-library directory, whose
    builds land by ``os.replace``, so replicas share it and all start."""

    @pytest.fixture(autouse=True)
    def _keep_build_dir(self, monkeypatch):
        from hyperopt_tpu_torch.ops import kernel_build

        # the cache dir is the process-wide kernel-library directory
        monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)

    def test_live_sibling_sharing_cache_dir_starts(self, tmp_path):
        root, cache = str(tmp_path / "root"), str(tmp_path / "cache")
        directory = ReplicaDirectory(root)
        directory.advertise("other", "http://other", compile_cache_dir=cache)
        svc = Svc(root=root, replica_id="me", advertise_url="http://me",
                  compile_cache_dir=cache, warmup=False)
        try:
            records = {r["replica_id"]: r for r in directory.replicas()}
            assert sorted(records) == ["me", "other"]
            assert records["me"]["compile_cache_dir"] == os.path.abspath(cache)
        finally:
            svc.close()

    def test_two_replicas_with_one_cache_dir_both_serve(self, tmp_path):
        root, cache = str(tmp_path / "root"), str(tmp_path / "cache")
        (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(root, compile_cache_dir=cache)
        try:
            client = ServiceClient(replicas=[u1, u2], deadline=60.0, retry_timeout=60.0,
                                   backoff_base=0.02, backoff_max=0.25)
            names = spread_names(client.ring, [u1, u2], 1, prefix="cc")
            for i, sid in enumerate(names):
                client.create_study(sid, SPACE, seed=i, algo_params=RAP)
                _drive_client(client, sid, 2)
                assert client.study_status(sid)["n_completed"] == 2
            # one owner per study, one study per replica
            owned = [[s.replica_set.owns(sid) for s in (s1, s2)] for sid in names]
            assert sorted(owned) == [[False, True], [True, False]], owned
        finally:
            _stop_all(srv1, srv2)

    def test_stale_sibling_record_does_not_refuse(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import _write_doc

        root, cache = str(tmp_path / "root"), str(tmp_path / "cache")
        directory = ReplicaDirectory(root)
        os.makedirs(directory.registry_dir, exist_ok=True)
        _write_doc(
            directory.record_path("dead"),
            {"replica_id": "dead", "url": "http://dead",
             "heartbeat_at": time.time() - 3600.0, "pid": 0,
             "compile_cache_dir": os.path.abspath(cache)},
            fsync_kind="attachment",
        )
        svc = Svc(root=root, replica_id="me", advertise_url="http://me",
                  compile_cache_dir=cache, warmup=False)
        try:
            assert directory.lookup("me")["compile_cache_dir"] == os.path.abspath(cache)
        finally:
            svc.close()


# ---------------------------------------------------------------------
# the JAX package's TestFS409ReplicaPlane
# ---------------------------------------------------------------------

FSCK_TTL = 2.0  # the expired-but-in-grace window is one TTL wide


class TestFS409ReplicaPlane:
    def _root_with_study(self, tmp_path, study="st"):
        root = str(tmp_path / "root")
        os.makedirs(os.path.join(root, "studies", study, "trials"))
        return root, StudyLeaseStore(root, ttl=FSCK_TTL), study

    def _rules(self, report):
        return [f.rule for f in report.findings]

    def test_orphan_lease_deleted(self, tmp_path):
        root, store, _ = self._root_with_study(tmp_path)
        store.claim("ghost", "r1")  # no studies/ghost directory
        # LIVE: the mid-create window, not damage
        report = fsck_path(root, repair=True)
        assert "FS409" not in self._rules(report)
        assert os.path.exists(store.lease_path("ghost"))
        _sleep_past(store.read("ghost")["expires_at"])
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        assert not os.path.exists(store.lease_path("ghost"))
        assert not os.path.exists(store.fence_path("ghost"))

    def test_expired_lease_reclaimed_fence_preserved(self, tmp_path):
        root, store, study = self._root_with_study(tmp_path)
        f1 = store.claim(study, "dead-replica")
        expires = store.read(study)["expires_at"]
        _sleep_past(expires)  # expired, inside one TTL of grace
        report = fsck_path(root, repair=True)
        assert "FS409" not in self._rules(report)
        assert store.read(study)["owner"] == "dead-replica"
        _sleep_past(expires + FSCK_TTL)  # past the grace too
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        lease = store.read(study)
        assert lease["owner"] is None and int(lease["fence"]) == f1
        assert not store.verify(study, "dead-replica", f1)
        assert store.claim(study, "r2") == f1 + 1

    def test_torn_lease_quarantined(self, tmp_path):
        root, store, study = self._root_with_study(tmp_path)
        store.claim(study, "r1")
        path = store.lease_path(study)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        assert not os.path.exists(path)
        assert any(n.startswith(os.path.basename(path) + ".corrupt")
                   for n in os.listdir(os.path.dirname(path)))

    def test_garbled_fence_counter_rewritten_past_evidence(self, tmp_path):
        root, store, study = self._root_with_study(tmp_path)
        fence = store.claim(study, "r1")
        with open(store.fence_path(study), "w") as f:
            f.write("not-a-number")
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        assert store.read_fence(study) == fence + 1

    def test_stuck_claimlock_cleared(self, tmp_path):
        root, store, study = self._root_with_study(tmp_path)
        lock = store._claim_lock_path(study)
        with open(lock, "w") as f:
            f.write("")
        report = fsck_path(root, repair=True)  # fresh: a live peer, untouched
        assert "FS409" not in self._rules(report)
        assert os.path.exists(lock)
        old = time.time() - 120.0
        os.utime(lock, (old, old))  # a claimant killed mid-claim
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        assert not os.path.exists(lock)

    def test_torn_registry_record_deleted(self, tmp_path):
        root = str(tmp_path / "root")
        directory = ReplicaDirectory(root)
        directory.advertise("r1", "http://127.0.0.1:1")
        path = directory.record_path("r1")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        report = fsck_path(root, repair=True)
        assert "FS409" in self._rules(report) and report.clean
        assert not os.path.exists(path)

    def test_live_plane_untouched_and_dry_run_reports_only(self, tmp_path):
        root, store, study = self._root_with_study(tmp_path)
        f1 = store.claim(study, "r1")
        store.claim("ghost", "r2")
        _sleep_past(store.read("ghost")["expires_at"])
        report = fsck_path(root, repair=False)
        assert "FS409" in self._rules(report) and not report.clean
        assert os.path.exists(store.lease_path("ghost"))
        assert not any(os.path.basename(f.path).startswith(study + ".")
                       for f in report.findings if f.rule == "FS409")
        assert store.verify(study, "r1", f1)


def _fs409_damage(root):
    """Every FS409 case in one root, made the same way in each copy."""
    jstore = jrep.StudyLeaseStore(root, ttl=60.0)
    for sid in ("a", "b", "c", "d", "e"):
        if sid != "e":  # e: a lease with no study directory
            os.makedirs(os.path.join(root, "studies", sid, "trials"))
        jstore.claim(sid, "r1")
    leases = os.path.join(root, "replicas", "leases")

    def rewrite(sid, **fields):
        from hyperopt_tpu.parallel.file_trials import _write_doc

        lease = jstore.read(sid)
        lease.update(fields)
        _write_doc(os.path.join(leases, f"{sid}.lease"), lease)

    now = time.time()
    rewrite("a", granted_at=now - 200.0, expires_at=now - 100.0)  # dead owner
    rewrite("e", granted_at=now - 200.0, expires_at=now - 100.0)  # orphan
    with open(os.path.join(leases, "b.fence"), "w") as f:
        f.write("garbled")
    path = os.path.join(leases, "c.lease")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    lock = os.path.join(leases, "d.claimlock")
    open(lock, "w").close()
    os.utime(lock, (now - 120.0, now - 120.0))
    jrep.ReplicaDirectory(root).advertise("r9", "http://127.0.0.1:9")
    record = os.path.join(root, "replicas", "registry", "r9.json")
    with open(record, "r+b") as f:
        f.truncate(os.path.getsize(record) // 2)


def _tree(root):
    from hyperopt_tpu_torch.parallel.file_trials import _decode_doc

    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "replicas")):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                raw = f.read()
            if name.endswith(".lease"):
                raw = json.dumps(_decode_doc(raw), sort_keys=True).encode()
            out[os.path.relpath(path, root).split(".corrupt")[0]] = raw
    return out


def test_fs409_findings_and_repairs_equal_the_jax_packages(tmp_path):
    """The same replica-plane damage in two copies of one root: the JAX
    package's fsck on one and the port's on the other find the same
    FS409 cases (dry run), repair them, and leave equal trees."""
    from hyperopt_tpu.resilience import fsck as jfsck

    base = str(tmp_path / "base")
    _fs409_damage(base)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, jroot)
    shutil.copytree(base, troot)

    def rows(report, root):
        return sorted((f.rule, os.path.relpath(f.path, root), f.detail.split(" (")[0])
                      for f in report.findings)

    jdry, tdry = jfsck.fsck_path(jroot), fsck_path(troot)
    assert rows(jdry, jroot) == rows(tdry, troot)
    # a's expired lease, e's orphan lease and fence, b's fence, c's torn
    # lease, d's stuck claim lock, r9's torn record
    assert len([r for r in rows(tdry, troot) if r[0] == "FS409"]) == 7
    jrep_, trep_ = jfsck.fsck_path(jroot, repair=True), fsck_path(troot, repair=True)
    assert jrep_.clean and trep_.clean
    assert [f.action.split(" to ")[0] for f in jrep_.findings] == [
        f.action.split(" to ")[0] for f in trep_.findings]
    jt, tt = _tree(jroot), _tree(troot)
    assert jt.keys() == tt.keys()
    for key in jt:
        assert jt[key] == tt[key], key


# ---------------------------------------------------------------------
# SL608 over ReplicaStats
# ---------------------------------------------------------------------


def _sl608(stats, clock):
    from hyperopt_tpu_torch import slo

    engine = slo.SloEngine(replica_stats=stats, time_fn=lambda: clock["t"],
                           snapshot_interval=1.0)
    engine.tick()
    clock["t"] += 60.0
    engine.tick()
    return lambda: {r["rule"]: r for r in engine.evaluate(force=True)}["SL608"]


class TestFailoverMttrRule:
    def test_reads_ok_after_a_clean_takeover(self):
        stats, clock = ReplicaStats(), {"t": 1000.0}
        row = _sl608(stats, clock)
        assert row()["status"] == "no_data"  # no takeover in the window
        stats.record_takeover({"study_id": "s", "ok": True, "duration_s": 1.5})
        assert row()["status"] == "ok"
        assert stats.slo_counters()["replica_takeovers"] == 1

    @pytest.mark.parametrize("record, counter", [
        ({"study_id": "s", "ok": True, "duration_s": 31.0}, "replica_takeovers_slow"),
        ({"study_id": "s", "ok": False, "duration_s": 0.5}, "replica_takeovers_failed"),
    ])
    def test_breaches_on_a_slow_or_failed_takeover(self, record, counter):
        stats, clock = ReplicaStats(), {"t": 1000.0}
        row = _sl608(stats, clock)
        stats.record_takeover(record)
        assert stats.slo_counters()[counter] == 1
        assert row()["status"] == "breach"

    def test_counters_equal_the_jax_packages(self):
        records = [{"ok": True, "duration_s": 2.0}, {"ok": True, "duration_s": 40.0},
                   {"ok": False, "duration_s": 1.0}]
        t, j = ReplicaStats(), jrep.ReplicaStats()
        for r in records:
            t.record_takeover(r)
            j.record_takeover(r)
        t.record("stale_write_dropped")
        j.record("stale_write_dropped")
        assert t.slo_counters() == j.slo_counters()
        assert t.summary() == j.summary()
        assert trep.DEFAULT_MTTR_BOUND_S == jrep.DEFAULT_MTTR_BOUND_S == 30.0

    def test_a_replica_service_feeds_sl608(self, tmp_path):
        svc = Svc(root=str(tmp_path / "r"), replica_id="r1", advertise_url="http://r1",
                  replica_ttl=30.0, warmup=False)
        try:
            assert svc.slo.replica_stats is svc.replica_set.stats
            assert "SL608" in {r["rule"] for r in svc.alerts()["rules"]}
            status = svc.service_status()
            assert status["replica"]["replica_id"] == "r1"
            # a CPU-device service launches no kernel
            assert status["kernel_launches"] == {
                "pair_score_batched": 0, "fused_suggest": 0, "pair_score_single": 0,
                "pair_lse_partials": 0}
        finally:
            svc.close()


# ---------------------------------------------------------------------
# what only the port has to show
# ---------------------------------------------------------------------


def test_lease_and_registry_files_read_across_packages(tmp_path):
    """Leases, fences, claim locks and registry records either package
    writes are read, verified and claimed by the other, and the fence
    only rises across the two."""
    root = str(tmp_path)
    j, t = jrep.StudyLeaseStore(root, ttl=60.0), StudyLeaseStore(root, ttl=60.0)
    fences = [j.claim("s", "jax-r")]
    assert t.owner_of("s") == ("jax-r", fences[0], True)
    assert t.verify("s", "jax-r", fences[0]) and t.read_fence("s") == fences[0]
    assert t.claim("s", "torch-r") is None  # live JAX holder
    assert j.release("s", "jax-r", fences[0])
    fences.append(t.claim("s", "torch-r"))  # released: claimed at once
    assert j.owner_of("s") == ("torch-r", fences[1], True)
    assert not j.verify("s", "jax-r", fences[0])
    assert t.renew("s", "torch-r", fences[1], ttl=0.05)  # then it stalls
    _sleep_past(t.read("s")["expires_at"])
    fences.append(j.claim("s", "jax-r"))  # expired: reclaimed
    assert not t.renew("s", "torch-r", fences[1])
    assert t.renew("s", "jax-r", fences[2]) and j.verify("s", "jax-r", fences[2])
    assert fences == [1, 2, 3]
    assert j.study_ids() == t.study_ids() == ["s"]
    # registry records
    jd, td = jrep.ReplicaDirectory(root, ttl=5.0), ReplicaDirectory(root, ttl=5.0)
    jd.advertise("ja", "http://127.0.0.1:1", compile_cache_dir=str(tmp_path / "c"))
    td.advertise("tb", "http://127.0.0.1:2")
    for d in (jd, td):
        recs = {r["replica_id"]: r for r in d.replicas()}
        assert set(recs) == {"ja", "tb"} and all(r["live"] for r in recs.values())
        assert recs["ja"]["compile_cache_dir"] == str(tmp_path / "c")
    assert td.url_of("ja") == "http://127.0.0.1:1" and jd.url_of("tb") == "http://127.0.0.1:2"
    assert sorted(trep.read_discovery(root)) == sorted(jrep.read_discovery(root))
    assert trep.read_discovery(os.path.join(root, "replicas", "registry")) == \
        trep.read_discovery(root)
    td.withdraw("tb")
    assert [r["replica_id"] for r in jd.replicas()] == ["ja"]


def test_replica_plane_passes_the_race_lint():
    """The port's own race lint passes on its replica plane and the
    service core that drives it."""
    from hyperopt_tpu_torch.analysis import lint_file

    for rel in ("service/replicas.py", "service/core.py", "compile_ledger.py"):
        path = os.path.join(ROOT, "hyperopt_tpu_torch", rel)
        assert lint_file(path) == [], rel


def test_ring_routes_as_the_jax_packages():
    urls = [f"http://127.0.0.1:{p}" for p in (8001, 8002, 8003)]
    tr, jr = trep.HashRing(urls), jrep.HashRing(urls)
    for i in range(200):
        assert tr.ordered(f"s{i}") == jr.ordered(f"s{i}")


def test_takeover_prewarm_dispatches_on_the_scheduler_thread_only(tmp_path, monkeypatch):
    """The survivor adopts on its reaper thread; the pre-warm's dispatch
    (and every later one) runs on its scheduler thread.  The in-process
    pair shares one warm-key set, so the survivor's is cleared after the
    crash, as a process of its own would start without the victim's."""
    launches = []
    real_family = tpe_device.multi_family_suggest_async
    real_multi = tpe_device.multi_study_suggest_async

    def family(requests, *a, **k):
        launches.append(("family", threading.current_thread().name))
        return real_family(requests, *a, **k)

    def multi(groups, *a, **k):
        launches.append(("batch", threading.current_thread().name))
        return real_multi(groups, *a, **k)

    monkeypatch.setattr(tpe_device, "multi_family_suggest_async", family)
    monkeypatch.setattr(tpe_device, "multi_study_suggest_async", multi)
    adopters = []
    (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path))
    real_adopt = s2._adopt_study

    def adopt(study_id, reason):
        adopters.append(threading.current_thread().name)
        return real_adopt(study_id, reason)

    s2.replica_set._adopt = adopt
    try:
        client = ServiceClient(replicas=[u1, u2], deadline=60.0, retry_timeout=60.0,
                               backoff_base=0.02, backoff_max=0.2)
        (sid,) = spread_names(client.ring, [u1], 1, prefix="pw")
        client.create_study(sid, SPACE, seed=4, algo_params=RAP)
        _drive_client(client, sid, RAP["n_startup_jobs"] + 2)
        assert s1.replica_set.owns(sid)
        _crash(s1, srv1)
        monkeypatch.setattr(tpe_device, "_warm_keys", set())
        del launches[:]
        _wait_until(s2.replica_set.stats.takeovers, what="the takeover's record")
        (rec,) = s2.replica_set.stats.takeovers()
        assert rec["ok"] and rec["fsck_clean"] and rec["reason"] == "expired"
        assert rec["prewarm"]["warm"] >= 1 and rec["prewarm"]["error"] == 0
        assert launches and {kind for kind, _ in launches} == {"family"}  # the pre-warm
        compiles = s2.stats.n_compile_events
        cold = s2.stats.summary()["n_cold_suggests"]
        _drive_client(client, sid, 1)  # the first suggest after the takeover
        assert s2.stats.summary()["n_cold_suggests"] == cold  # served warm
        assert s2.stats.n_compile_events == compiles
        _drive_client(client, sid, 2)
        assert {name for _, name in launches} == {"hyperopt-service-scheduler"}
        assert adopters and all(n.startswith("hyperopt-replica-reaper") for n in adopters)
    finally:
        _stop_all(srv1, srv2)


def test_a_takeover_refuses_to_run_on_the_scheduler_thread(tmp_path):
    """The pre-warm is a task queued behind the caller: a takeover on the
    scheduler thread would wait on itself, so it raises instead."""
    svc = Svc(root=str(tmp_path / "r"), replica_id="r1", advertise_url="http://r1",
              replica_ttl=30.0, warmup=False)
    try:
        out, done = [], threading.Event()

        def task():
            try:
                svc._adopt_study("nobody", "test")
            except RuntimeError as e:
                out.append(e)
            finally:
                done.set()

        svc.scheduler.call_soon(task)
        assert done.wait(WAIT_S)
        assert out and "scheduler thread" in str(out[0])
    finally:
        svc.close()


def test_migrated_anneal_study_equals_the_jax_services_docs(tmp_path):
    """``anneal`` draws from numpy streams in both packages: a study
    served by one port replica, migrated, and finished by the other
    serves the JAX service's docs, trial for trial."""
    n_pre, n_post = 4, 4
    jsvc = JaxService(root=None, batch_window=0.001, warmup=False)
    try:
        jsvc.create_study("an", J_SPACE, seed=5, algo="anneal")
        want, losses = [], []
        for _ in range(n_pre + n_post):
            (a,) = jsvc.suggest("an")
            want.append(a)
            losses.append(_objective(space_eval(SPACE, a["vals"])))
            jsvc.report("an", a["tid"], loss=losses[-1])
    finally:
        jsvc.close()
    (s1, srv1, u1), (s2, srv2, u2) = _replica_pair(str(tmp_path))
    got = []
    try:
        client = ServiceClient(replicas=[u1, u2], deadline=60.0, retry_timeout=60.0,
                               backoff_base=0.02, backoff_max=0.2)
        (sid,) = spread_names(client.ring, [u1], 1, prefix="an")
        client.create_study(sid, SPACE, seed=5, algo="anneal")
        for i in range(n_pre + n_post):
            if i == n_pre:
                _crash(s1, srv1)
            (b,) = client.suggest(sid)
            got.append(b)
            client.report(sid, b["tid"], loss=losses[i])  # the JAX point's loss
        assert s2.replica_set.owns(sid)
    finally:
        _stop_all(srv1, srv2)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a["tid"] == b["tid"] and a["vals"].keys() == b["vals"].keys(), (a, b)
        for k in a["vals"]:
            assert np.isclose(a["vals"][k], b["vals"][k], rtol=1e-5, atol=0), (k, a, b)


def test_compile_ledger_shared_by_two_replicas_keeps_both_records(tmp_path):
    """Two replicas append to one root's ledger; a compaction by either
    keeps the records its sibling appended since it loaded the file."""
    from hyperopt_tpu_torch import compile_ledger as ledger_mod

    path = str(tmp_path / ledger_mod.LEDGER_FILENAME)
    a, b = ledger_mod.CompileLedger(path), ledger_mod.CompileLedger(path)

    def sig_shapes(n):
        return ((("cont", (("k", n),)),), [[((4,), "float32")]])

    a.record_compile(*sig_shapes(1000), 0.5)
    b.record_compile(*sig_shapes(2000), 0.5)
    a.refresh()  # a takeover folds in what its sibling recorded
    assert ledger_mod.replay_key(*sig_shapes(2000)) in {r["replay_key"] for r in a.entries()}
    n_b = 0
    while b._appends_since_compact or n_b == 0:  # until b compacts
        b.record_compile(*sig_shapes(n_b % 3), 0.1)
        n_b += 1
        assert n_b < 1000
    reread = ledger_mod.CompileLedger(path)
    keys = {r["replay_key"] for r in reread.entries()}
    assert ledger_mod.replay_key(*sig_shapes(1000)) in keys
    assert len(keys) == 5 and reread.n_torn_lines == 0


def test_compile_ledger_shared_by_two_replicas_keeps_the_newest_record_of_a_key(tmp_path):
    """Both replicas record one key; each numbers its records itself, so
    the older record carries the higher seq.  A reload, a refresh and a
    compaction by the replica holding the older record all keep the
    newer one."""
    from hyperopt_tpu_torch import compile_ledger as ledger_mod

    path = str(tmp_path / ledger_mod.LEDGER_FILENAME)
    a, b = ledger_mod.CompileLedger(path), ledger_mod.CompileLedger(path)

    def sig_shapes(n):
        return ((("cont", (("k", n),)),), [[((4,), "float32")]])

    key = ledger_mod.replay_key(*sig_shapes(7))

    def duration_of(ledger):
        (rec,) = [r for r in ledger.entries() if r["replay_key"] == key]
        return rec["duration_s"]

    a.record_compile(*sig_shapes(1), 0.1)
    old = a.record_compile(*sig_shapes(7), 0.5)
    new = b.record_compile(*sig_shapes(7), 0.75)  # later, at a lower seq
    assert new["seq"] < old["seq"]
    assert duration_of(ledger_mod.CompileLedger(path)) == 0.75
    a.refresh()
    assert duration_of(a) == 0.75
    n_a = 0
    while a._appends_since_compact or n_a == 0:  # until a compacts
        a.record_compile(*sig_shapes(100 + n_a % 2), 0.1)
        n_a += 1
        assert n_a < 1000
    reread = ledger_mod.CompileLedger(path)
    assert duration_of(reread) == 0.75 and len(reread) == 4


def test_replica_mode_needs_a_root_and_a_card(tmp_path):
    """A replica needs a shared root, and, like the single replica, the
    card unless it is given ``device="cpu"``: no CPU fallback."""
    with pytest.raises(ValueError, match="root"):
        Svc(root=None, replica_id="r1")
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from hyperopt_tpu_torch.service import OptimizationService\n"
        "try:\n"
        f"    OptimizationService(root={str(tmp_path / 'r')!r}, replica_id='r1', warmup=False)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "    print('refused')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=WAIT_S, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr
    assert not os.path.exists(tmp_path / "r" / "replicas")


def test_cli_argument_checks(tmp_path):
    from hyperopt_tpu_torch.service.__main__ import main

    root = str(tmp_path / "r")
    assert main(["--device", "cpu", "--replica-id", "r1", "--port", "0"]) == 2
    assert main(["--device", "cpu", "--root", root, "--replica-id", "r1", "--port", "0"]) == 2
    assert main(["--device", "cpu", "--root", root, "--mirror-src-root", root]) == 2
    assert not os.path.exists(os.path.join(root, "replicas"))


def _spawn_replica(root, port, rid, log, *args):
    return spawn_service(
        root, port, log, "--device", "cpu", "--replica-id", rid, "--advertise-url",
        f"http://127.0.0.1:{port}", "--replica-ttl", "2.0", "--batch-window", "0.001",
        "--no-warmup", *args)


def test_cli_replicas_fail_over_across_processes(tmp_path):
    """Flow 4 on the port with two replicas: two ``--replica-id`` servers
    on one root, ``kill -9`` one, the client continues every study to the
    single-process trajectory, SIGTERM of the survivor exits 0 with every
    lease released, and ``fsck`` (FS409 included) exits 0.  Both replicas
    name one ``--compile-cache-dir``: the port shares it."""
    root = str(tmp_path / "root")
    ports = [free_port(), free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    log = open(tmp_path / "replicas.log", "w+")
    procs = [_spawn_replica(root, p, f"r{i + 1}", log, "--compile-cache-dir",
                            str(tmp_path / "cache")) for i, p in enumerate(ports)]
    try:
        for u in urls:
            ServiceClient(u).wait_ready(timeout=WAIT_S)
        client = ServiceClient(replicas=urls, deadline=90.0, retry_timeout=90.0,
                               backoff_base=0.02, backoff_max=0.25)
        names = spread_names(client.ring, urls, 1, prefix="cli")
        for i, sid in enumerate(names):
            client.create_study(sid, SPACE, seed=20 + i, algo_params=RAP)
            _drive_client(client, sid, 3)
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=WAIT_S)
        for sid in names:
            _drive_client(client, sid, 3)
        doc = ServiceClient(urls[1]).replicas()
        assert sorted(doc["owned_studies"]) == sorted(names)
        (rec,) = doc["stats"]["recent_takeovers"]
        assert rec["ok"] and rec["fsck_clean"] and rec["from_owner"] == "r1"
        assert procs[1].poll() is None
        procs[1].send_signal(signal.SIGTERM)
        assert procs[1].wait(timeout=WAIT_S) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        log.close()
    for i, sid in enumerate(names):
        _assert_vals_close(_study_vals_on_disk(root, sid), _serial_fmin_vals(20 + i, 6))
        lease = StudyLeaseStore(root).read(sid)
        assert lease["owner"] is None and lease["fence"] >= 1  # released, fence kept
    assert ReplicaDirectory(root).lookup("r2") is None  # withdrawn
    out = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service", "fsck",
                          root, "--json"], capture_output=True, text=True, timeout=WAIT_S,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["clean"] is True and report["n_queues"] == 2
